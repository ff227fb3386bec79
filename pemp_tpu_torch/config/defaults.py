"""The port's configuration: the keys the eval slice reads, with the names
and defaults of pemp_tpu.config.defaults, and nothing else.

A YAML file of the repo's ``configs/`` loads through :func:`update_config`
(PyYAML is imported only there). Each of its keys is one of:

* a key of the tree below: merged;
* a key of :data:`FIXED`, whose behaviour the slice implements for one
  value only: the file must give that value, else loading raises
  ``NotImplementedError``;
* a key of :data:`NOT_READ`, which cannot change what the eval slice
  computes (run and logging settings, data loading, training, the other
  backbone, the stages after decode): dropped.

Any other key raises ``KeyError``, and so does setting a key the tree does
not hold. The ``MODEL.MPN`` subtree takes new keys, as in the JAX package;
the model checks it (``models.mpn.models._check_fused_path``).
:func:`w48_640` carries ``configs/hrnet/w48_640.yaml`` as Python, for
machines without PyYAML.
"""

from pemp_tpu_torch.config.node import ConfigNode as CN


def _stage(modules, branches, blocks, channels):
    return {"NUM_MODULES": modules, "NUM_BRANCHES": branches,
            "NUM_BLOCKS": blocks, "NUM_CHANNELS": channels}


_C = CN({
    "DATASET": {"NUM_JOINTS": 17},
    "MODEL": {
        "FEATURE_GATHER_KERNEL": 3,
        "HRNET": {
            "NUM_JOINTS": 17,
            "TAG_PER_JOINT": True,
            "FEATURE_FUSION": "avg",
            "SCOREMAP_MODE": "avg",
            "LOSS": {"WITH_AE_LOSS": (True, False)},   # sizes the tag head
            "EXTRA": {
                "STEM_INPLANES": 64,
                "FINAL_CONV_KERNEL": 1,
                "STAGE2": _stage(1, 2, [4, 4], [32, 64]),
                "STAGE3": _stage(4, 3, [4, 4, 4], [32, 64, 128]),
                "STAGE4": _stage(3, 4, [4, 4, 4, 4], [32, 64, 128, 256]),
                "DECONV": {"NUM_DECONVS": 1, "NUM_CHANNELS": [32],
                           "NUM_BASIC_BLOCKS": 4, "KERNEL_SIZE": [4],
                           "CAT_OUTPUT": [True]},
            },
        },
        "MPN": CN({
            "NODE_TYPE_SUMMARY": "not",
            "NAME": "VanillaMPN",
            "STEPS": 10,
            "NODE_STEPS": 0,
            "EDGE_MLP": "agnostic",
            "NODE_INPUT_DIM": 128,
            "AGGR_TYPE": "agnostic",
            "EDGE_INPUT_DIM": 19,
            "EDGE_FEATURE_DIM": 64,
            "EDGE_FEATURE_HIDDEN": 64,
            "NODE_FEATURE_DIM": 64,
            "NODE_EMB": {},
            "EDGE_EMB": {},
            "CLASS": {},
            "BN": True,
            "AGGR_SUB": "None",
            "UPDATE_TYPE": "mlp",
            "SKIP": False,
            "LATE_FUSION_POS": False,
            "NUM_JOINTS": 17,
            "NODE_THRESHOLD": 0.5,
        }, new_allowed=True),
        "GC": {
            "POOL_KERNEL_SIZE": 3,
            "MASK_CROWDS": True,
            "DETECT_THRESHOLD": 0.005,
            "HYBRID_K": 5,
            "NORM_NODE_DISTANCE": False,
            "EDGE_FEATURES_TO_USE": ["position", "connection_type"],
        },
    },
    # graph sizing of the JAX package (no reference equivalent)
    "TPU": {
        "NODES_PER_TYPE": 40,   # K: padded detections per joint type
        "KNN_K": 50,
        "KNN_CAP_IN": 30,       # C = KNN_K + KNN_CAP_IN slots per node
    },
})

# The only values the slice implements. The eval it runs is bench.py's:
# HigherHRNet with the standard deconvolution, the target-major kNN graph
# on detections, the fused MPN step with per-step outputs off, threshold
# grouping with fill, refine and quarter adjust, one scale, no flip.
FIXED = {
    "MODEL.KP": ("hrnet",),
    "MODEL.PRETRAINED": ("",),                  # weights come from the caller
    **{f"MODEL.HRNET.EXTRA.STAGE{i}.BLOCK": ("BASIC",) for i in (2, 3, 4)},
    **{f"MODEL.HRNET.EXTRA.STAGE{i}.FUSE_METHOD": ("SUM",) for i in (2, 3, 4)},
    "MODEL.GC.GRAPH_TYPE": ("knn",),
    "MODEL.GC.USE_GT": (False,),
    "MODEL.GC.CC_METHOD": ("threshold",),
    "TPU.TARGET_MAJOR": (True,),
    "TPU.MSG_PASS": ("fused_step",),
    "TPU.COLLECT_AUX": (False,),
    "TPU.S2D_DECONV": (-1, 0),                  # -1 picks the standard form off a TPU
    "TEST.FLIP_TEST": (False,),
    "TEST.SCALE_FACTOR": ([1.0],),
    "TEST.FILL_MEAN": (True,),
    "TEST.WITH_REFINE": (True,),
    "TEST.ADJUST": (True,),
}


def _under(prefix: str, names: str) -> set:
    return {f"{prefix}.{n}" for n in names.split()}


NOT_READ = frozenset({
    # run, logging, devices
    "OUTPUT_DIR", "LOG_DIR", "DATA_DIR", "GPUS", "WORKERS", "PRINT_FREQ", "CUDNN",
    "AUTO_RESUME", "PIN_MEMORY", "RANK", "VERBOSE", "DIST_BACKEND",
    "MULTIPROCESSING_DISTRIBUTED",
    # data loading and augmentation (the network is fully convolutional)
    *_under("DATASET", "ROOT DATASET WITH_CENTER MAX_NUM_PEOPLE SCALING_TYPE SIGMA "
                       "HEAT_GENERATOR MAX_ROTATION MIN_SCALE MAX_SCALE SCALE_TYPE "
                       "MAX_TRANSLATE INPUT_SIZE OUTPUT_SIZE FLIP"),
    # training: losses, schedules, graph labels, backbone initialisation
    "TRAIN", "UB", "TPU.MATCHER",
    *_under("MODEL", "LOSS AUX_STEPS WITH_FLIP_KERNEL FOCAL_LOSS"),
    *_under("MODEL.HRNET", "PRETRAINED SYNC_BN"),
    *_under("MODEL.HRNET.LOSS", "NUM_STAGES WITH_HEATMAPS_LOSS HEATMAPS_LOSS_FACTOR "
                                "AE_LOSS_TYPE PUSH_LOSS_FACTOR PULL_LOSS_FACTOR"),
    "MODEL.HRNET.EXTRA.PRETRAINED_LAYERS",
    *_under("MODEL.GC", "CHEAT USE_NEIGHBOURS EDGE_LABEL_METHOD WITH_BACKGROUND "
                        "MATCHING_RADIUS INCLUSION_RADIUS GT_FOR_END2END "
                        "IMAGE_CENTRIC_SAMPLING NODE_MATCHING_RADIUS "
                        "NODE_INCLUSION_RADIUS WEIGHT_CLASS_LOSS NODE_DROPOUT"),
    # names and sizes the JAX package does not read either
    *_under("MODEL", "KP_OUTPUT_DIM FEATURE_GATHER_PADDING"),
    *_under("MODEL.HRNET", "NAME INPUT_SIZE OUTPUT_SIZE"),
    "MODEL.GC.NAME",
    # the other backbone (MODEL.KP is fixed to hrnet)
    "MODEL.HG",
    # evaluation sets, test-time augmentation and output formatting, which
    # come after the persons the pipeline returns
    *_under("TEST", "SPLIT NUM_EVAL PROJECT_TO_IMAGE PROJECT2IMAGE REFINE_COMP "
                    "WITH_HEATMAPS WITH_AE FLIP_AND_REARANGE WITH_POSE_FILTER SCORING"),
    # how the JAX package runs on a TPU; the working type is the entry
    # points' ``dtype`` argument
    *_under("TPU", "USE_PALLAS SCAN_UNROLL COMPILE_BUDGET COMPUTE_DTYPE MESH_DATA "
                   "DECODE_ON_DEVICE"),
})


def _drop_unread(tree: dict, prefix: str = "") -> dict:
    """``tree`` without its :data:`FIXED` and :data:`NOT_READ` keys; raises
    on a fixed key whose value the slice does not implement."""
    kept = {}
    for k, v in tree.items():
        key = prefix + k
        if key in FIXED:
            if v not in FIXED[key]:
                raise NotImplementedError(
                    f"{key}={v!r}: the port implements only {FIXED[key]}")
        elif key in NOT_READ:
            continue
        elif isinstance(v, dict):
            sub = _drop_unread(v, key + ".")
            if sub or not v:
                kept[k] = sub
        else:
            kept[k] = v
    return kept


def get_config():
    return _C.clone()


def update_config(cfg, config_file):
    """Merges the YAML file ``config_file`` into ``cfg`` and returns it."""
    import yaml  # only YAML files need PyYAML; the presets are plain Python

    with open(config_file) as f:
        cfg.merge_from_other(_drop_unread(yaml.safe_load(f) or {}))
    return cfg


# configs/hrnet/w48_640.yaml, the keys of it that the slice reads
W48_640 = {
    "MODEL": {
        "HRNET": {
            "NUM_JOINTS": 17,
            "TAG_PER_JOINT": True,
            "FEATURE_FUSION": "small",
            "EXTRA": {
                "STEM_INPLANES": 64,
                "FINAL_CONV_KERNEL": 1,
                "STAGE2": _stage(1, 2, [4, 4], [48, 96]),
                "STAGE3": _stage(4, 3, [4, 4, 4], [48, 96, 192]),
                "STAGE4": _stage(3, 4, [4, 4, 4, 4], [48, 96, 192, 384]),
                "DECONV": {"NUM_DECONVS": 1, "NUM_CHANNELS": [48], "KERNEL_SIZE": [4],
                           "NUM_BASIC_BLOCKS": 4, "CAT_OUTPUT": [True]},
            },
        },
        "MPN": {
            "NAME": "NodeClassificationMPN",
            "STEPS": 10,
            "NODE_STEPS": 0,
            "AGGR_TYPE": "per_type",
            "NODE_INPUT_DIM": 128,
            "EDGE_INPUT_DIM": 19,
            "NODE_FEATURE_DIM": 64,
            "EDGE_FEATURE_DIM": 64,
            "EDGE_FEATURE_HIDDEN": 64,
            "NODE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [128, 64, 64]},
            "EDGE_EMB": {"BN": True, "END_WITH_RELU": False,
                         "OUTPUT_SIZES": [32, 64, 64, 64]},
            "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 1]},
            "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 1]},
            "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 17]},
            "BN": False,
            "AGGR": "add",
            "AGGR_SUB": "node_edge_attn",
            "SKIP": True,
            "NODE_THRESHOLD": 0.1,
        },
        "GC": {
            "POOL_KERNEL_SIZE": 3,
            "MASK_CROWDS": True,
            "DETECT_THRESHOLD": 0.1,
            "NORM_NODE_DISTANCE": True,
        },
    },
}


def w48_640():
    """HigherHRNet-w48 at 640 with the flagship MPN head, as
    ``update_config(get_config(), "configs/hrnet/w48_640.yaml")`` gives it,
    built without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(W48_640)
    return cfg


# A narrow HigherHRNet (widths 8-32, one block per branch) at 64x64 with the
# flagship MPN widths, K = 8 detections per type and 3 MPN steps: the size
# the CPU parity tests and the card's CPU-against-card check run at. K = 8
# keeps 17 * K a multiple of 8, which the JAX package's fused-step tiling
# needs (pemp_tpu.models.mpn.layers.fused_tile_ok); otherwise the JAX side
# would take its unfused path.
SMALL = {
    "MODEL": {
        "HRNET": {
            "EXTRA": {
                "STAGE2": {"NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [8, 16]},
                "STAGE3": {"NUM_MODULES": 1, "NUM_BLOCKS": [1, 1, 1],
                           "NUM_CHANNELS": [8, 16, 24]},
                "STAGE4": {"NUM_MODULES": 2, "NUM_BLOCKS": [1, 1, 1, 1],
                           "NUM_CHANNELS": [8, 16, 24, 32]},
                "DECONV": {"NUM_CHANNELS": [8], "NUM_BASIC_BLOCKS": 1},
            },
        },
        "MPN": {"STEPS": 3},
    },
    "TPU": {"NODES_PER_TYPE": 8},
}


def small():
    """:data:`W48_640` cut to :data:`SMALL`'s size."""
    cfg = w48_640()
    cfg.merge_from_other(SMALL)
    return cfg
