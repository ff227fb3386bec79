"""The port's configuration: the keys its paths read, with the names and
defaults of pemp_tpu.config.defaults, and nothing else.

A YAML file of the repo's ``configs/`` loads through :func:`update_config`
(PyYAML is imported only there). Each of its keys is one of:

* a key of the tree below: merged;
* a key of :data:`FIXED`, whose value no path of the port implements
  otherwise (the backbone, the graph type, collect-at-eval, the message
  passing forms): a file giving another value raises
  ``NotImplementedError``;
* a key of :data:`NOT_READ`, which no path reads (device and run
  settings, the loss terms and heads the port refuses, the stages after
  decode): dropped.

Any other key raises ``KeyError``, and so does setting a key the tree does
not hold. The ``MODEL.MPN`` subtree takes new keys, as in the JAX package;
the model checks it (``models.mpn.models._check_flagship``).

Each path then checks the values it implements for one setting only:
:func:`check_path` with ``"eval"`` (the bench's pipeline), ``"valid"`` (the
eval entry point, ``python -m pemp_tpu_torch.valid``), ``"valid_hr"`` (the
AE-grouping entry point, ``python -m pemp_tpu_torch.valid_hr``) or
``"train"`` (the trainer), against :data:`EVAL_FIXED`, :data:`VALID_FIXED`,
:data:`VALID_HR_FIXED` or :data:`TRAIN_FIXED` and :func:`msg_pass_route`
(with :func:`plain_route`: the routes with kernels need the target-major
kNN graph and the per-type layer).
The presets (:data:`PRESETS`: :func:`w48_640`, :func:`w32_512_train`,
:func:`model_81_1_2`, :func:`hg_512` and :func:`w32_512`) carry five files
of ``configs/`` as Python, for machines without PyYAML;
:func:`load_config` resolves a ``--config`` name to a preset or a file.
:data:`ABLATIONS`, :data:`ZOO` and :data:`VARIANTS` hold deltas over
model_58_4 (:func:`ablation`, :func:`zoo`, :func:`variant`).
"""

import ast
import functools
import pathlib

from pemp_tpu_torch.config.node import ConfigNode as CN


def _stage(modules, branches, blocks, channels):
    return {"NUM_MODULES": modules, "NUM_BRANCHES": branches,
            "NUM_BLOCKS": blocks, "NUM_CHANNELS": channels}


_C = CN({
    "LOG_DIR": "",
    "WORKERS": 4,
    "PRINT_FREQ": 20,
    "DATASET": {
        "ROOT": "data/coco",
        "DATASET": "coco",
        "SCALING_TYPE": "short",
        "NUM_JOINTS": 17,
        "MAX_NUM_PEOPLE": 30,
        "INPUT_SIZE": 512,
        "OUTPUT_SIZE": [128, 256],
        # training augmentation (data.transforms)
        "MAX_ROTATION": 30,
        "MIN_SCALE": 0.75,
        "MAX_SCALE": 1.25,
        "MAX_TRANSLATE": 40,
        "FLIP": 0.5,
    },
    "MODEL": {
        "KP": "hrnet",
        "PRETRAINED": "",
        "FEATURE_GATHER_KERNEL": 3,
        "LOSS": {
            "NAME": ["edge_loss"],
            "NODE_WEIGHT": 1.0,
            "EDGE_WEIGHT": 1.0,
            "CLASS_WEIGHT": 1.0,
            "USE_FOCAL": True,
            "NODE_USE_FOCAL": True,
            "FOCAL_ALPHA": 1.0,
            "FOCAL_GAMMA": 2.0,
            "EDGE_BCE_POS_WEIGHT": 1.0,
            "INCLUDE_BORDERING_NODES": False,
            # the tag-regression, background and node-edge factories
            "TAG_WEIGHT": 1.0,
            "SYNC_TAGS": False,
            "NODE_BCE_POS_WEIGHT": 1.0,
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
        # the 4-stack Hourglass (MODEL.KP hourglass): stacks, width, head
        # channels (17 heatmaps, 17 tags, 34 unused)
        "HG": {"NSTACK": 4, "INPUT_DIM": 256, "OUTPUT_DIM": 68},
        "HRNET": {
            "NUM_JOINTS": 17,
            "TAG_PER_JOINT": True,
            "FEATURE_FUSION": "avg",
            "SCOREMAP_MODE": "avg",
            "LOSS": {
                "WITH_AE_LOSS": (True, False),   # sizes the tag head
                "WITH_HEATMAPS_LOSS": (True, True),
                "HEATMAPS_LOSS_FACTOR": (1.0, 1.0),
                "AE_LOSS_TYPE": "exp",
                "PUSH_LOSS_FACTOR": (0.001, 0.001),
                "PULL_LOSS_FACTOR": (0.001, 0.001),
            },
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
            # the per-node tag head (NodeClassificationMPNTag, MPNTag)
            "NODE_TAG": {"BN": True, "OUTPUT_SIZES": [1]},
            "BN": True,
            "AGGR": "max",
            "AGGR_SUB": "None",
            "UPDATE_TYPE": "mlp",
            "SKIP": False,
            "AUX_LOSS_STEPS": 0,
            # ClassificationMPNSimple{,2}'s passes after the node head
            # (models.mpn.zoo); ClassificationMPN's STEPS_NODE and STEPS_GROUP
            # are in neither package's tree: a file adds them, absent they
            # read STEPS and 0 (pemp_tpu/models/mpn/zoo.py:110, 126)
            "EDGE_STEPS": 0,
            "LATE_FUSION_POS": False,
            "NUM_JOINTS": 17,
            "NODE_THRESHOLD": 0.5,
        }, new_allowed=True),
        "GC": {
            "POOL_KERNEL_SIZE": 3,
            "MASK_CROWDS": True,
            "DETECT_THRESHOLD": 0.005,
            "HYBRID_K": 5,
            "GRAPH_TYPE": "knn",
            "NORM_NODE_DISTANCE": False,
            "EDGE_FEATURES_TO_USE": ["position", "connection_type"],
            "CC_METHOD": "GAEC",
            # training labels
            "EDGE_LABEL_METHOD": 4,
            "MATCHING_RADIUS": 0.1,
            "INCLUSION_RADIUS": 0.75,
            "NODE_MATCHING_RADIUS": 0.5,
            "NODE_INCLUSION_RADIUS": 0.7,
            "USE_NEIGHBOURS": False,
            # the GT joints as the nodes (training and the upper bounds)
            "USE_GT": False,
            "WITH_BACKGROUND": False,
            "IMAGE_CENTRIC_SAMPLING": False,
            "WEIGHT_CLASS_LOSS": False,
            "NODE_DROPOUT": 0.0,
        },
    },
    # the upper-bound model's backbone (models.upper_bound)
    "UB": {"KP": "hrnet"},
    "TEST": {
        "SPLIT": "coco_17_mini",
        "FLIP_TEST": True,
        "FLIP_AND_REARANGE": True,
        "SCALE_FACTOR": [0.5, 1.0, 2.0],
        "PROJECT2IMAGE": True,
        "FILL_MEAN": True,
        "WITH_REFINE": False,
        "ADJUST": True,
        "SCORING": "correct",
    },
    "TRAIN": {
        "SPLIT": "coco_17_mini",
        "START_EPOCH": 0,
        "END_EPOCH": 100,
        "CONTINUE": "",
        "FINETUNE": False,
        "LR": 3e-4,
        "KP_LR": 1e-5,
        "LR_FACTOR": 0.1,
        "LR_STEP": [60, 150],
        "W_DECAY": 0.0,
        "KP_W_DECAY": 0.0,
        "BATCH_SIZE": 8,
        "END_TO_END": False,
        "KP_FREEZE_MODE": "complete",
        "FREEZE_BN": True,
        "WITH_AE_LOSS": [False, False],
    },
    # graph sizing and routing of the JAX package (no reference equivalent)
    "TPU": {
        "NODES_PER_TYPE": 40,   # K: padded detections per joint type
        "KNN_K": 50,
        "KNN_CAP_IN": 30,       # C = KNN_K + KNN_CAP_IN slots per node
        "MSG_PASS": "auto",
        # the kNN graph's layout: target-major blocks of C in-edge slots a
        # node (the kernel routes), or the edge list of pemp_tpu/ops/knn.py:
        # 36-71 (the segment route)
        "TARGET_MAJOR": True,
        "MATCHER": "hungarian",
        "S2D_DECONV": -1,
    },
})

# The graphs graph.constructor builds (pemp_tpu/graph/constructor.py:143-170):
# kNN (target-major, or an edge list with ``TPU.TARGET_MAJOR`` false),
# fully connected, the two root-joint graphs, the per-type top-k graph and
# kNN in the node features' space.
GRAPH_TYPES = ("knn", "fully", "score_based", "score_based_per_type", "topk", "feature_knn")

# Values no path of the port implements otherwise: the three backbones
# (HigherHRNet, the same network under mmpose's checkpoint names, the
# 4-stack Hourglass; also the upper-bound model's ``UB.KP``), HigherHRNet's
# standard blocks, per-step MPN outputs only where training asks for them,
# and the message-passing routes (``ROUTES``). Refused when a file is
# loaded.
FIXED = {
    "MODEL.KP": ("hrnet", "mmpose_hrnet", "hourglass"),
    "UB.KP": ("hrnet", "mmpose_hrnet", "hourglass"),
    **{f"MODEL.HRNET.EXTRA.STAGE{i}.BLOCK": ("BASIC",) for i in (2, 3, 4)},
    **{f"MODEL.HRNET.EXTRA.STAGE{i}.FUSE_METHOD": ("SUM",) for i in (2, 3, 4)},
    "MODEL.GC.GRAPH_TYPE": GRAPH_TYPES,
    "TPU.COLLECT_AUX": (False,),
    "TPU.MSG_PASS": ("auto", "fused_step", "pallas", "hybrid", "einsum", "dots"),
}

# The message-passing forms the eval and training paths both run
# (pemp_tpu/models/mpn/layers.py): the fused step (K1, backward K2b, K1b
# and G1), the typed message kernel (K2, backward K2b), on the symmetric
# kNN layout with the reverse-edge permutation the slim attention
# aggregation (K3, backward K3b) or the blocked aggregate (K4, backward
# K4b), and on the asymmetric layout the all-types projection followed by
# the blocked aggregate (``dots``).
ROUTES = ("fused_step", "pallas", "hybrid", "einsum", "dots")

# The routes that need type-blocked nodes (type(n) == (n // K) mod J): the
# fused step's in-kernel types and the reverse-edge permutation's static
# type blocks. ``MODEL.GC.USE_GT`` makes the GT joints the nodes,
# person-major, where the JAX package silently takes its plain per-type
# layer instead (pemp_tpu/models/pose_estimation.py:212-218,
# pemp_tpu/models/mpn/models.py:147-155); the port refuses them by name.
TYPE_BLOCKED_ROUTES = ("fused_step", "hybrid", "einsum")

# The eval path is bench.py's: weights from the caller, threshold grouping
# with fill, refine and quarter adjust, one scale, no flip, the standard
# deconvolution (-1 picks it off a TPU).
EVAL_FIXED = {
    # every eval path builds its graph on detections: the JAX package puts
    # the GT joints among the nodes only when given them, which no eval
    # path does
    "MODEL.GC.USE_GT": (False,),
    "MODEL.PRETRAINED": ("",),
    "MODEL.GC.CC_METHOD": ("threshold",),
    "TPU.S2D_DECONV": (-1, 0),
    "TEST.FLIP_TEST": (False,),
    "TEST.SCALE_FACTOR": ([1.0],),
    "TEST.FILL_MEAN": (True,),
    "TEST.WITH_REFINE": (True,),
    "TEST.ADJUST": (True,),
}

# The eval entry point (valid.py) runs multi-scale + flip test-time
# augmentation, short- or long-side scaling, and groups by threshold on the
# card, by correlation clustering or greedily (decode/greedy.py) on the
# host; tag-regression MPNs group by their tags whatever the method.
VALID_FIXED = {
    "MODEL.GC.USE_GT": (False,),
    "MODEL.GC.CC_METHOD": ("threshold", "GAEC", "KL", "MUT", "greedy"),
    "DATASET.SCALING_TYPE": ("short", "long"),
    "TPU.S2D_DECONV": (-1, 0),
}

# The AE-grouping entry point (valid_hr.py): the backbone alone under the
# same test-time augmentation, grouped on the host by the AE parsers and by
# correlation clustering on the tags.
VALID_HR_FIXED = {
    "MODEL.GC.USE_GT": (False,),
    "DATASET.SCALING_TYPE": ("short", "long"),
    "TPU.S2D_DECONV": (-1, 0),
}

# The training path labels edges by methods 1-7 (with or without the
# neighbour pass, auction or greedy matcher; ``TPU.MATCHER`` values other
# than greedy are the auction), on detections or on the GT joints
# (``USE_GT``), with or without the weighted class loss and the background
# class (``WITH_BACKGROUND``, read by method 6). Node dropout and
# image-centric sampling act only with a random key, and the JAX trainer
# passes the model none (pemp_tpu/train/train_step.py:57-67), so they never
# act there: refused.
TRAIN_FIXED = {
    "MODEL.GC.EDGE_LABEL_METHOD": (1, 2, 3, 4, 5, 6, 7),
    "MODEL.GC.IMAGE_CENTRIC_SAMPLING": (False,),
    "MODEL.GC.NODE_DROPOUT": (0.0,),
}
# why a path refuses a value, where the table alone does not say
_WHY = dict.fromkeys(("MODEL.GC.IMAGE_CENTRIC_SAMPLING", "MODEL.GC.NODE_DROPOUT"),
                     "; the JAX trainer draws no graph key (pemp_tpu/train/train_step.py:"
                     "57-67), so this never acts there")

# The upper-bound path (models.upper_bound and calc_upper_bounds): the GT
# labels as predictions, on the backbone of ``UB.KP``, with any label
# method but the background class: tools/calc_upper_bounds.py sets label
# method 2 (:53-54), where WITH_BACKGROUND does not act, so neither
# package's upper bounds run it.
UB_FIXED = {"MODEL.GC.WITH_BACKGROUND": (False,)}


def _under(prefix: str, names: str) -> set:
    return {f"{prefix}.{n}" for n in names.split()}


NOT_READ = frozenset({
    # run, logging, devices
    "OUTPUT_DIR", "DATA_DIR", "GPUS", "CUDNN",
    "AUTO_RESUME", "PIN_MEMORY", "RANK", "VERBOSE", "DIST_BACKEND",
    "MULTIPROCESSING_DISTRIBUTED",
    # data settings no path reads (augmentation scales by SCALING_TYPE, and
    # the heatmaps' sigma is the generator's own)
    *_under("DATASET", "WITH_CENTER SIGMA HEAT_GENERATOR SCALE_TYPE"),
    # training settings the JAX trainer does not read either
    *_under("TRAIN", "SPLIT_OPTIMIZER LOSS_REDUCTION USE_LABEL_MASK USE_BATCH_INDEX"),
    # the upper bounds read UB.KP only (pemp_tpu/models/upper_bound.py,
    # tools/calc_upper_bounds.py)
    *_under("UB", "GC NUM_EVAL ADJUST SPLIT REFINE"),
    # legacy keys no factory of either package acts on (the JAX package's
    # ClassMultiLossFactory stores EDGE_WITH_LOGITS and never reads it)
    *_under("MODEL", "AUX_STEPS WITH_FLIP_KERNEL FOCAL_LOSS"),
    *_under("MODEL.LOSS", "SYNC_GT_TAGS EDGE_WITH_LOGITS"),
    *_under("MODEL.HRNET", "PRETRAINED SYNC_BN"),
    "MODEL.HRNET.LOSS.NUM_STAGES",
    "MODEL.HRNET.EXTRA.PRETRAINED_LAYERS",
    *_under("MODEL.GC", "CHEAT GT_FOR_END2END"),
    # names and sizes the JAX package does not read either
    *_under("MODEL", "KP_OUTPUT_DIM FEATURE_GATHER_PADDING"),
    *_under("MODEL.HRNET", "NAME INPUT_SIZE OUTPUT_SIZE"),
    *_under("MODEL.HG", "NAME PRETRAINED"),
    "MODEL.GC.NAME",
    # evaluation settings of the JAX package's other tools (the upper
    # bounds; valid_hr.py reads REFINE_COMP as ``REFINE_COMP or True``,
    # always refining) and the reference's dead keys
    *_under("TEST", "NUM_EVAL PROJECT_TO_IMAGE REFINE_COMP WITH_HEATMAPS WITH_AE "
                    "WITH_POSE_FILTER"),
    # how the JAX package runs on a TPU; the working type is the entry
    # points' ``dtype`` argument
    *_under("TPU", "USE_PALLAS SCAN_UNROLL COMPILE_BUDGET COMPUTE_DTYPE MESH_DATA "
                   "DECODE_ON_DEVICE"),
})


def _drop_unread(tree: dict, prefix: str = "", node=None) -> dict:
    """``tree`` without its :data:`NOT_READ` keys and the :data:`FIXED`
    keys the tree does not hold; raises on a fixed key whose value no path
    implements."""
    node = _C if node is None else node
    kept = {}
    for k, v in tree.items():
        key = prefix + k
        if key in FIXED and v not in FIXED[key]:
            raise NotImplementedError(
                f"{key}={v!r}: the port implements only {FIXED[key]}")
        if key in NOT_READ or (key in FIXED and k not in node):
            continue
        child = node.get(k) if isinstance(node, dict) else None
        if isinstance(v, dict) and isinstance(child, dict):
            sub = _drop_unread(v, key + ".", child)
            if sub or not v:
                kept[k] = sub
        else:
            kept[k] = v
    return kept


def _lookup(cfg, key: str):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


# The routes that run no kernel, as the JAX package runs no Pallas kernel
# there (pemp_tpu/models/pose_estimation.py:205-214): ``segment`` on an
# edge list (every graph but the target-major kNN one), whose scatters are
# plain XLA (pemp_tpu/ops/segment.py:21-103), and ``agnostic``, the
# type-agnostic MPLayer (pemp_tpu/models/mpn/layers.py:293-351).
PLAIN_ROUTES = {
    "segment": "the kernels need the target-major blocked kNN layout, and these edges "
               "are an edge list",
    "agnostic": "the type-agnostic MPLayer (MODEL.MPN.AGGR_TYPE agnostic, VanillaMPN, and "
                "the zoo's ClassificationMPN, Attention, SelfAttention and VanillaMPN2) "
                "runs no kernel",
}


# The MPNs whose layer is MPLayer whatever ``AGGR_TYPE`` says, and
# VanillaMPN2, whose layer is its own: no kernel on any layout
# (pemp_tpu/models/mpn/zoo.py:100-104, 167-170, 260-262, 675-758).
AGNOSTIC_MPNS = ("VanillaMPN", "ClassificationMPN", "NodeClassificationMPNAttention",
                 "NodeClassificationMPNSelfAttention", "VanillaMPN2")


def plain_route(cfg):
    """The kernel-free route ``cfg``'s MPN runs (:data:`PLAIN_ROUTES`), or
    None where it runs the kernel routes: ``agnostic`` for the MPNs of
    :data:`AGNOSTIC_MPNS` and ``MODEL.MPN.AGGR_TYPE`` agnostic, else
    ``segment`` unless the graph is the target-major kNN one (the kNN
    graph with ``TPU.TARGET_MAJOR`` false is an edge list)."""
    mpn = cfg.MODEL.MPN
    if mpn.NAME in AGNOSTIC_MPNS or mpn.AGGR_TYPE == "agnostic":
        return "agnostic"
    if cfg.MODEL.GC.GRAPH_TYPE != "knn" or not cfg.TPU.TARGET_MAJOR:
        return "segment"
    return None


# Why a path's message passing cannot take the routes that need
# type-blocked nodes (:data:`TYPE_BLOCKED_ROUTES`), by the setting that
# says so (:func:`unblocked_by`).
UNBLOCKED = {
    "use_gt": "with MODEL.GC.USE_GT: the nodes are the GT joints, person-major, and this "
              "route needs type-blocked nodes",
    "group_based": "with MODEL.MPN.NAME NodeClassificationMPNGroupBased: its two masked "
                   "passes a step run the shared layer as the JAX package calls it, without "
                   "the fused step or the reverse-edge projection",
}


def unblocked_by(cfg) -> str | None:
    """None where ``cfg``'s MPN may take every route, else the key of
    :data:`UNBLOCKED` that limits it to ``pallas`` and ``dots``."""
    if cfg.MODEL.GC.USE_GT:
        return "use_gt"
    if cfg.MODEL.MPN.NAME == "NodeClassificationMPNGroupBased":
        return "group_based"
    return None


def msg_pass_route(msg_pass: str, train: bool, plain: str | None = None,
                   unblocked: str | None = None) -> str:
    """``TPU.MSG_PASS`` as the JAX package resolves it on a TPU
    (pemp_tpu.models.pose_estimation.build_pose_model): ``auto`` is the
    fused step (K1) at eval, where per-step outputs are off, and the
    per-op kernel with its backward (K2, K2b) in training, which collects
    them; any other value names its route. On a kernel-free path
    (``plain``, from :func:`plain_route`) ``auto`` is that route and any
    kernel route raises: the JAX package ignores it there, the port does
    not fall back silently. Where the nodes are not type-blocked
    (``unblocked``, a key of :data:`UNBLOCKED`: ``USE_GT``, the group-based
    MPN) ``auto`` is ``pallas`` in both modes and
    :data:`TYPE_BLOCKED_ROUTES` raise. Raises ``NotImplementedError`` for a
    route the port does not run (not one of :data:`ROUTES`)."""
    if plain is not None:
        if msg_pass != "auto":
            raise NotImplementedError(
                f"TPU.MSG_PASS={msg_pass!r}: {PLAIN_ROUTES[plain]}; only 'auto' (the "
                f"{plain} route) runs here")
        return plain
    route = msg_pass
    if route == "auto":
        route = "pallas" if train or unblocked else "fused_step"
    if unblocked and route in TYPE_BLOCKED_ROUTES:
        raise NotImplementedError(
            f"TPU.MSG_PASS={msg_pass!r} {UNBLOCKED[unblocked]}; 'pallas' and 'dots' run here")
    if route not in ROUTES:
        raise NotImplementedError(f"TPU.MSG_PASS={msg_pass!r}: the port runs only {ROUTES}")
    return route


def layer_route(route: str, edge_mlp: str, aggr_sub: str) -> str:
    """The form of the per-type layer that runs on the kernel route
    ``route`` (:data:`ROUTES`) given ``MODEL.MPN.EDGE_MLP`` and
    ``AGGR_SUB``, as the JAX layer chooses it on a TPU
    (pemp_tpu/models/mpn/layers.py:393-404, 551-556, 630-662), else
    ``route`` itself:

    * K1, K2 and K3 aggregate by one attention head. With an ``AGGR_SUB``
      other than ``node_edge_attn`` the JAX layer runs its split linear,
      then the blocked aggregate (K4 for ``node_edge_attn_per_type``, a
      plain per-type sum by ``MPN.AGGR`` otherwise): with the reverse-edge
      projection on the symmetric layout (``einsum``, for ``hybrid`` and
      ``einsum``), with the all-types one on the asymmetric layout
      (``dots``, for the other routes).
    * The fused step (K1) computes the agnostic edge MLP in the kernel.
      With ``EDGE_MLP`` per_type the JAX layer takes its typed message
      kernel there instead (K2, and K2b in training): ``pallas``.
    """
    if aggr_sub != "node_edge_attn":
        return "einsum" if route in ("hybrid", "einsum") else "dots"
    if route == "fused_step" and edge_mlp != "agnostic":
        return "pallas"
    return route


def check_path(cfg, path: str) -> None:
    """Raises ``NotImplementedError`` unless ``cfg`` asks the ``"eval"``,
    ``"valid"``, ``"valid_hr"``, ``"train"`` or ``"upper_bound"`` path for
    what the port implements there."""
    fixed = {"eval": EVAL_FIXED, "valid": VALID_FIXED, "valid_hr": VALID_HR_FIXED,
             "train": TRAIN_FIXED, "upper_bound": UB_FIXED}[path]
    for key, allowed in fixed.items():
        value = _lookup(cfg, key)
        if value not in allowed:
            raise NotImplementedError(f"{key}={value!r}: the port's {path} path implements "
                                      f"only {allowed}{_WHY.get(key, '')}")
    if cfg.DATASET.SCALING_TYPE == "long" and cfg.DATASET.INPUT_SIZE != 512:
        # pemp_tpu/geometry/affine.py:200-215 asserts it: the reference maps
        # back through a transform fixed at 512
        raise NotImplementedError(
            f"DATASET.SCALING_TYPE='long' at DATASET.INPUT_SIZE="
            f"{cfg.DATASET.INPUT_SIZE}: the long-side reverse map is fixed at 512")
    if path in ("eval", "valid", "train"):
        msg_pass_route(cfg.TPU.MSG_PASS, path == "train", plain_route(cfg), unblocked_by(cfg))


def get_config():
    return _C.clone()


def update_config(cfg, config_file):
    """Merges the YAML file ``config_file`` into ``cfg`` and returns it."""
    import yaml  # only YAML files need PyYAML; the presets are plain Python

    with open(config_file) as f:
        cfg.merge_from_other(_drop_unread(yaml.safe_load(f) or {}))
    return cfg


def update_config_command(cfg, opts):
    """Merges ``KEY VALUE`` pairs (``TEST.FLIP_TEST True``) into ``cfg`` as
    a file's keys merge: values are Python literals or plain strings, keys
    no path reads are dropped and fixed values are checked."""
    if len(opts) % 2:
        raise ValueError(f"options must be KEY VALUE pairs, got {opts}")
    tree: dict = {}
    for key, value in zip(opts[0::2], opts[1::2]):
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        try:
            node[leaf] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            node[leaf] = value
    cfg.merge_from_other(_drop_unread(tree))
    return cfg


CONFIGS = pathlib.Path(__file__).resolve().parents[2] / "configs"


def load_config(name: str):
    """The configuration a ``--config`` name gives: the files the port
    carries as presets (:data:`PRESETS`) come from them (no PyYAML needed),
    any other name is ``configs/<name>.yaml`` (or a path ending in
    ``.yaml``)."""
    if name in PRESETS:
        return PRESETS[name]()
    path = name if name.endswith(".yaml") else str(CONFIGS / f"{name}.yaml")
    return update_config(get_config(), path)


# the flagship MPN head, as both presets' files give it
_FLAGSHIP_MPN = {
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
    "EDGE_EMB": {"BN": True, "END_WITH_RELU": False, "OUTPUT_SIZES": [32, 64, 64, 64]},
    "EDGE_CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 1]},
    "NODE_CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 1]},
    "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 17]},
    "BN": False,
    "AGGR": "add",
    "AGGR_SUB": "node_edge_attn",
    "SKIP": True,
}

# configs/hrnet/w48_640.yaml, the keys of it that the port reads
W48_640 = {
    "DATASET": {"INPUT_SIZE": 640, "OUTPUT_SIZE": [160, 320], "SCALING_TYPE": "short"},
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
        "MPN": {**_FLAGSHIP_MPN, "NODE_THRESHOLD": 0.1},
        "GC": {
            "POOL_KERNEL_SIZE": 3,
            "EDGE_LABEL_METHOD": 6,
            "MASK_CROWDS": True,
            "DETECT_THRESHOLD": 0.1,
            "MATCHING_RADIUS": 0.5,
            "INCLUSION_RADIUS": 0.75,
            "CC_METHOD": "threshold",
            "NORM_NODE_DISTANCE": True,
        },
    },
    "TEST": {"SPLIT": "coco_17_full", "ADJUST": True, "FLIP_TEST": False,
             "WITH_REFINE": True, "SCALE_FACTOR": [1.0], "PROJECT2IMAGE": True},
}


def w48_640():
    """HigherHRNet-w48 at 640 with the flagship MPN head, as
    ``update_config(get_config(), "configs/hrnet/w48_640.yaml")`` gives it,
    built without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(W48_640)
    return cfg


# configs/hybrid_class_agnostic_end2end/model_58_4.yaml, the keys of it that
# the port reads: HigherHRNet-w32 at 512 (the default tree), its
# augmentation, the flagship MPN, method-6 labels, losses [edge, node,
# class, heatmap], split-LR AdamW, 11 epochs
MODEL_58_4 = {
    "LOG_DIR": "log/PoseEstimationBaseline/Real_node/58_4",
    "DATASET": {"ROOT": "data/coco", "MAX_NUM_PEOPLE": 30, "SCALING_TYPE": "short",
                "MAX_ROTATION": 30, "MIN_SCALE": 0.75, "MAX_SCALE": 1.5, "MAX_TRANSLATE": 40,
                "FLIP": 0.5},
    "MODEL": {
        "PRETRAINED": "log/PoseEstimationBaseline/Real_node/58_4/pose_estimation.ckpt",
        "HRNET": {
            "NUM_JOINTS": 17,
            "TAG_PER_JOINT": True,
            "FEATURE_FUSION": "small",
            "LOSS": {"AE_LOSS_TYPE": "exp", "WITH_AE_LOSS": [True, False],
                     "PUSH_LOSS_FACTOR": [0.001, 0.001], "PULL_LOSS_FACTOR": [0.001, 0.001],
                     "WITH_HEATMAPS_LOSS": [True, True], "HEATMAPS_LOSS_FACTOR": [1.0, 1.0]},
        },
        "MPN": {**_FLAGSHIP_MPN, "NODE_THRESHOLD": 1.0},
        "GC": {
            "USE_NEIGHBOURS": False,
            "POOL_KERNEL_SIZE": 3,
            "EDGE_LABEL_METHOD": 6,
            "MASK_CROWDS": True,
            "DETECT_THRESHOLD": 0.1,
            "MATCHING_RADIUS": 0.5,
            "INCLUSION_RADIUS": 0.75,
            "CC_METHOD": "GAEC",
            "NORM_NODE_DISTANCE": True,
        },
        "LOSS": {"NAME": ["edge", "node", "class", "heatmap"], "USE_FOCAL": True,
                 "FOCAL_GAMMA": 2.0, "FOCAL_ALPHA": 1.0},
    },
    "TEST": {"SPLIT": "coco_17_full", "ADJUST": True, "FLIP_TEST": False,
             "WITH_REFINE": True, "SCALE_FACTOR": [1.0], "PROJECT2IMAGE": True},
    "TRAIN": {
        "SPLIT": "coco_17_full",
        "START_EPOCH": 0,
        "END_EPOCH": 11,
        "CONTINUE": "",
        "LR": 3.0e-4,
        "KP_LR": 1.0e-6,
        "KP_W_DECAY": 0.0001,
        "LR_FACTOR": 0.1,
        "LR_STEP": [10, 30],
        "BATCH_SIZE": 8,
        "END_TO_END": True,
        "FREEZE_BN": True,
        "KP_FREEZE_MODE": "nothing",
    },
}


def w32_512_train():
    """model_58_4, the flagship training configuration (HigherHRNet-w32 at
    512, batch 8), as ``update_config(get_config(),
    "configs/hybrid_class_agnostic_end2end/model_58_4.yaml")`` gives it,
    built without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(MODEL_58_4)
    return cfg


# configs/crowdpose/model_81_1_2.yaml, the keys of it that the port reads:
# the CrowdPose flagship, HigherHRNet-w32 at 512 under mmpose's checkpoint
# names, 14 joint types, the flagship MPN at T = 14 (EDGE_INPUT_DIM 14 + 2),
# no crowd masking, trained as model_58_4
MODEL_81_1_2 = {
    "LOG_DIR": "log/PoseEstimationBaseline/Real_node/81_1_2",
    "DATASET": {"ROOT": "data/crowd_pose", "DATASET": "crowd_pose", "NUM_JOINTS": 14,
                "MAX_NUM_PEOPLE": 30, "SCALING_TYPE": "short", "MAX_ROTATION": 30,
                "MIN_SCALE": 0.75, "MAX_SCALE": 1.5, "MAX_TRANSLATE": 40, "FLIP": 0.5},
    "MODEL": {
        "KP": "mmpose_hrnet",
        "PRETRAINED": "log/PoseEstimationBaseline/Real_node/81_1_2/pose_estimation.ckpt",
        "HRNET": {
            "NUM_JOINTS": 14,
            "TAG_PER_JOINT": True,
            "FEATURE_FUSION": "small",
            "LOSS": {"AE_LOSS_TYPE": "exp", "WITH_AE_LOSS": [True, False],
                     "PUSH_LOSS_FACTOR": [0.001, 0.001], "PULL_LOSS_FACTOR": [0.001, 0.001],
                     "WITH_HEATMAPS_LOSS": [True, True], "HEATMAPS_LOSS_FACTOR": [1.0, 1.0]},
        },
        "MPN": {**_FLAGSHIP_MPN, "NUM_JOINTS": 14, "EDGE_INPUT_DIM": 16,
                "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 14]}, "NODE_THRESHOLD": 1.0},
        "GC": {
            "USE_NEIGHBOURS": False,
            "POOL_KERNEL_SIZE": 3,
            "EDGE_LABEL_METHOD": 6,
            "MASK_CROWDS": False,
            "DETECT_THRESHOLD": 0.1,
            "MATCHING_RADIUS": 0.5,
            "INCLUSION_RADIUS": 0.75,
            "CC_METHOD": "GAEC",
            "NORM_NODE_DISTANCE": True,
        },
        "LOSS": {"NAME": ["edge", "node", "class", "heatmap"], "USE_FOCAL": True,
                 "FOCAL_GAMMA": 2.0, "FOCAL_ALPHA": 1.0},
    },
    "TEST": {"SPLIT": "crowd_pose_test", "ADJUST": True, "FLIP_TEST": False,
             "WITH_REFINE": True, "SCALE_FACTOR": [1.0], "PROJECT2IMAGE": True},
    "TRAIN": {
        "SPLIT": "crowd_pose_trainval",
        "LR": 3.0e-4,
        "KP_LR": 1.0e-6,
        "KP_W_DECAY": 0.0001,
        "LR_FACTOR": 0.1,
        "LR_STEP": [10, 30],
        "BATCH_SIZE": 8,
        "END_EPOCH": 11,
        "END_TO_END": True,
        "FREEZE_BN": True,
        "KP_FREEZE_MODE": "nothing",
    },
}


def model_81_1_2():
    """The CrowdPose flagship as ``update_config(get_config(),
    "configs/crowdpose/model_81_1_2.yaml")`` gives it, built without
    PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(MODEL_81_1_2)
    return cfg


# configs/hourglass/hg_512.yaml, the keys of it that the port reads: the
# 4-stack Hourglass at 512 with long-side scaling. The file names no MPN,
# so the tree's default VanillaMPN stands: it runs through valid_hr only.
HG_512 = {
    "LOG_DIR": "log/hourglass/hg_512",
    "DATASET": {"ROOT": "data/coco", "MAX_NUM_PEOPLE": 30, "SCALING_TYPE": "long",
                "INPUT_SIZE": 512, "OUTPUT_SIZE": [128, 128, 128, 128], "MAX_ROTATION": 0,
                "MIN_SCALE": 1.0, "MAX_SCALE": 1.0, "MAX_TRANSLATE": 0, "FLIP": 0.0},
    "MODEL": {"KP": "hourglass", "HG": {"NSTACK": 4, "INPUT_DIM": 256, "OUTPUT_DIM": 68}},
    "TEST": {"SPLIT": "coco_17_full", "ADJUST": True, "WITH_REFINE": True, "FLIP_TEST": False,
             "SCALE_FACTOR": [1.0], "PROJECT2IMAGE": False},
}


def hg_512():
    """The Hourglass AE baseline as ``update_config(get_config(),
    "configs/hourglass/hg_512.yaml")`` gives it, built without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(HG_512)
    return cfg


# configs/hrnet/w32_512.yaml, the keys of it that the port reads:
# HigherHRNet-w32 at 512 with flip, the backbone-parity configuration of
# the AE-grouping entry point (its MPN is the tree's default, VanillaMPN)
W32_512 = {
    "LOG_DIR": "log/hrnet/w32_512",
    "DATASET": {"ROOT": "data/coco", "INPUT_SIZE": 512, "OUTPUT_SIZE": [128, 256],
                "SCALING_TYPE": "short", "MAX_NUM_PEOPLE": 30},
    "MODEL": {"KP": "hrnet",
              "HRNET": {"NUM_JOINTS": 17, "TAG_PER_JOINT": True, "FEATURE_FUSION": "small"}},
    "TEST": {"SPLIT": "coco_17_full", "ADJUST": True, "WITH_REFINE": True, "FLIP_TEST": True,
             "SCALE_FACTOR": [1.0], "PROJECT2IMAGE": True},
}


def w32_512():
    """HigherHRNet-w32 at 512 as ``update_config(get_config(),
    "configs/hrnet/w32_512.yaml")`` gives it, built without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(W32_512)
    return cfg


# configs/upper_bound/*.yaml, the keys of them that the port reads: the
# upper bounds' backbones (``UB.KP``) and graph settings over the default
# tree, as tools/calc_upper_bounds.py loads each file alone
UPPER_BOUNDS = {
    "upper_bound/hg": {
        "LOG_DIR": "log/upper_bound/hg",
        "DATASET": {"ROOT": "data/coco", "SCALING_TYPE": "long",
                    "OUTPUT_SIZE": [128, 128, 128, 128]},
        "MODEL": {"KP": "hourglass", "HG": {"NSTACK": 4, "INPUT_DIM": 256, "OUTPUT_DIM": 68}},
        "UB": {"KP": "hourglass"},
    },
    "upper_bound/hrnet": {
        "LOG_DIR": "log/upper_bound/hrnet",
        "DATASET": {"ROOT": "data/coco", "SCALING_TYPE": "short"},
        "MODEL": {"KP": "hrnet",
                  "GC": {"EDGE_LABEL_METHOD": 6, "GRAPH_TYPE": "knn", "MATCHING_RADIUS": 0.5}},
        "UB": {"KP": "hrnet"},
    },
    "upper_bound/mmpose_hrnet": {
        "LOG_DIR": "log/upper_bound/mmpose_hrnet",
        "DATASET": {"DATASET": "crowd_pose", "ROOT": "data/crowdpose", "NUM_JOINTS": 14},
        "MODEL": {"KP": "mmpose_hrnet", "HRNET": {"NUM_JOINTS": 14},
                  "MPN": {"NUM_JOINTS": 14, "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 14]}}},
        "UB": {"KP": "mmpose_hrnet"},
    },
}


def upper_bound(name: str):
    """The upper-bound file ``name`` (a key of :data:`UPPER_BOUNDS`) as
    ``update_config(get_config(), "configs/<name>.yaml")`` gives it, built
    without PyYAML."""
    cfg = get_config()
    cfg.merge_from_other(UPPER_BOUNDS[name])
    return cfg


# the ``--config`` names that resolve to a preset
PRESETS = {
    "hrnet/w48_640": w48_640,
    "hybrid_class_agnostic_end2end/model_58_4": w32_512_train,
    "crowdpose/model_81_1_2": model_81_1_2,
    "hourglass/hg_512": hg_512,
    "hrnet/w32_512": w32_512,
    **{name: functools.partial(upper_bound, name) for name in UPPER_BOUNDS},
}


def _features(sets, width, agnostic=False):
    mpn = {"EDGE_INPUT_DIM": width, **({"AGGR_TYPE": "agnostic"} if agnostic else {})}
    return {"MODEL": {"GC": {"EDGE_FEATURES_TO_USE": sets}, "MPN": mpn,
                      "LOSS": {"NAME": ["edge", "node", "class", "heatmap"]}}}


_FROZEN = {"END_TO_END": False, "KP_FREEZE_MODE": "complete"}

# The ablation files of configs/ as Python, but their LOG_DIR: deltas over
# the flagship (their header says so). Loaded alone they leave the tree's
# VanillaMPN without sizes; both packages run them as model_58_4 with the
# delta's keys as KEY VALUE options, which :func:`ablation` gives without
# PyYAML.
ABLATIONS = {
    "connectivity/fully": {"MODEL": {"GC": {"GRAPH_TYPE": "fully"}}},
    "connectivity/score_based": {"MODEL": {"GC": {"GRAPH_TYPE": "score_based"}}},
    "connectivity/score_based_per_type": {"MODEL": {"GC": {"GRAPH_TYPE":
                                                           "score_based_per_type"}}},
    "feature_importance/model_nothing": _features(["nothing"], 1),
    "feature_importance/model_position": _features(["position"], 2),
    "feature_importance/model_type": _features(["connection_type"], 17),
    "feature_importance/model_gostic_nothing": _features(["nothing"], 1, True),
    "feature_importance/model_gostic_position": _features(["position"], 2, True),
    "feature_importance/model_gostic_type": _features(["connection_type"], 17, True),
    "train/model_50_4": {"MODEL": {"MPN": {"NAME": "VanillaMPN", "AGGR_TYPE": "agnostic"},
                                   "LOSS": {"NAME": ["edge"]}}, "TRAIN": _FROZEN},
    "train/model_56_2": {"MODEL": {"GC": {"EDGE_LABEL_METHOD": 4, "USE_NEIGHBOURS": True},
                                   "LOSS": {"NAME": ["edge", "node"]}}, "TRAIN": _FROZEN},
    "class_agnostic_end2end/model_57_1": {"MODEL": {"LOSS": {"NAME": ["edge", "node",
                                                                      "heatmap"]}},
                                          "TRAIN": {"END_TO_END": True}},
    "matching_th/matching_03": {"MODEL": {"GC": {"MATCHING_RADIUS": 0.3}}},
    "matching_th/matching_07": {"MODEL": {"GC": {"MATCHING_RADIUS": 0.7}}},
    "semi_vs_pure/pure": {"MODEL": {"GC": {"EDGE_LABEL_METHOD": 6}}},
    # their KP_OUTPUT_DIM is read by neither package (NOT_READ); ``cat``
    # is refused by both (models.hrnet)
    **{f"node_feature_selection/hrnet_{mode}": {"MODEL": {"HRNET": {"FEATURE_FUSION": mode}}}
       for mode in ("avg", "large", "small")},
}


def ablation(name: str, base=None):
    """``base`` (the model_58_4 preset when None) with the ablation delta
    ``name`` (a key of :data:`ABLATIONS`) merged over it."""
    cfg = w32_512_train() if base is None else base
    cfg.merge_from_other(ABLATIONS[name])
    return cfg


_TAG_HEAD = {"BN": True, "OUTPUT_SIZES": [64, 32, 1]}
_NO_CLASS = {"NAME": ["edge", "node", "heatmap"]}

# The tag-regression, background-class, group-based and greedy-grouping
# configurations, and the research zoo's ClassificationMPNSimple (the
# architecture of 64 of the reference's experiment files; per-type layer,
# two edge passes after the node head), ClassificationMPN with its grouping
# phase and SelfAttention, as deltas over model_58_4 (no file of configs/
# sets them; the names and keys are the JAX package's:
# pemp_tpu/models/mpn/models.py:373-651, pemp_tpu/models/mpn/zoo.py,
# pemp_tpu/losses/factories.py:363-548, tools/valid.py:165-212), at its full
# width. The models without a class head train without a class loss.
# :func:`zoo` merges one over a base.
ZOO = {
    "tag": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNTag", "NODE_TAG": _TAG_HEAD,
                              "TAG_SKIP": True},
                      "LOSS": {"NAME": "tag_loss", "LOSS_WEIGHTS": [1.0, 1.0, 1.0]}}},
    "background": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNWithBackground",
                                     "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 18]}},
                             "GC": {"WITH_BACKGROUND": True},
                             "LOSS": {"NAME": "node_with_background_edge_loss",
                                      "LOSS_WEIGHTS": [1.0, 1.0]}}},
    "group_based": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNGroupBased"}}},
    "greedy": {"MODEL": {"GC": {"CC_METHOD": "greedy"}}},
    "simple": {"MODEL": {"MPN": {"NAME": "ClassificationMPNSimple", "AGGR_TYPE": "per_type",
                                 "EDGE_STEPS": 2},
                         "LOSS": _NO_CLASS}},
    "two_phase": {"MODEL": {"MPN": {"NAME": "ClassificationMPN", "STEPS_NODE": 5,
                                    "STEPS_GROUP": 5},
                            "LOSS": _NO_CLASS}},
    "self_attention": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNSelfAttention"}}},
}
# and the models that run on the small cut only: MPNTag (the type-agnostic
# MPLayer, trained by the pure tag loss with the first stage's tags pooled
# in), the class head alone, trained by the background factory's class
# loss (its node-edge loss reads a node head it has not: both packages
# refuse that), and the zoo's other seven (VanillaMPN2 edge-only, its head
# one output wide)
ZOO_CUTS = {
    "pure_tag": {"MODEL": {"MPN": {"NAME": "MPNTag", "AGGR_TYPE": "agnostic",
                                   "NODE_TAG": _TAG_HEAD},
                           "LOSS": {"NAME": "pure_tag_loss", "SYNC_TAGS": True}}},
    "joint_type": {"MODEL": {"MPN": {"NAME": "JointTypeClassification",
                                     "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 18]}},
                             "GC": {"WITH_BACKGROUND": True},
                             "LOSS": {"NAME": "node_with_background_edge_loss",
                                      "LOSS_WEIGHTS": [1.0, 1.0]}}},
    "simple2": {"MODEL": {"MPN": {"NAME": "ClassificationMPNSimple2", "EDGE_STEPS": 2},
                          "LOSS": _NO_CLASS}},
    "type_based": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNTypeBased"}}},
    "type_constrained": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNTypeConstrained"}}},
    "fp_constrained": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNFPConstrained"}}},
    "with_ref": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNWithRef", "NODE_STEPS": 1}}},
    "attention": {"MODEL": {"MPN": {"NAME": "NodeClassificationMPNAttention", "NODE_STEPS": 2}}},
    "vanilla2": {"MODEL": {"MPN": {"NAME": "VanillaMPN2",
                                   "CLASS": {"BN": True, "OUTPUT_SIZES": [64, 32, 1]}},
                           "LOSS": {"NAME": ["edge"]}}},
}


def zoo(name: str, base=None):
    """``base`` (the model_58_4 preset when None) with the delta ``name`` (a
    key of :data:`ZOO` or :data:`ZOO_CUTS`) merged over it."""
    cfg = w32_512_train() if base is None else base
    cfg.merge_from_other({**ZOO, **ZOO_CUTS}[name])
    return cfg


def _mpn(**keys):
    return {"MODEL": {"MPN": keys}}


def _vanilla(**keys):
    """train/model_50_4 (VanillaMPN, the edge loss, a frozen backbone) with
    ``keys`` in its MPN."""
    delta = ABLATIONS["train/model_50_4"]
    return {**delta, "MODEL": {**delta["MODEL"], "MPN": {**delta["MODEL"]["MPN"], **keys}}}


def _edge_set(sets, width):
    return {"MODEL": {"GC": {"EDGE_FEATURES_TO_USE": sets}, "MPN": {"EDGE_INPUT_DIM": width}}}


# The JAX package's MPN and graph variants that no file of configs/ sets
# (the architecture and graph ablations of the thesis code), as deltas over
# model_58_4 in the JAX package's keys; the vanilla ones over
# train/model_50_4. :func:`variant` merges one over a base. The layer
# variants run on the kernel routes (config.layer_route says which form),
# the graph variants on the segment route, VanillaMPN's on agnostic.
VARIANTS = {
    "edge_mlp_per_type": _mpn(EDGE_MLP="per_type"),
    "update_hierarch": _mpn(UPDATE_TYPE="hierarch_mlp"),
    "attn_per_type": _mpn(AGGR_SUB="node_edge_attn_per_type"),
    "aggr_per_type": _mpn(AGGR_SUB="None"),
    "node_steps": _mpn(NODE_STEPS=2),
    "late_fusion": _mpn(LATE_FUSION_POS=True),
    "angle": _edge_set(["position", "angle", "connection_type"], 20),
    "ae_normed": _edge_set(["position", "connection_type", "ae_normed"], 20),
    "knn_list": {"TPU": {"TARGET_MAJOR": False}},
    "topk": {"MODEL": {"GC": {"GRAPH_TYPE": "topk"}}},
    "feature_knn": {"MODEL": {"GC": {"GRAPH_TYPE": "feature_knn"}}},
    "vanilla_per_type": _vanilla(EDGE_MLP="per_type"),
    "vanilla_update_mlp": _vanilla(USE_NODE_UPDATE_MLP=True),
    "vanilla_drop_dist": _vanilla(DROP_FEATURE="edge_dist"),
}
# and the values of the same keys that run on the small cut only: the
# per-type aggregation by max and mean, the tag-distance sets alone
VARIANT_CUTS = {
    "aggr_max": _mpn(AGGR_SUB="None", AGGR="max"),
    "aggr_mean": _mpn(AGGR_SUB="None", AGGR="mean"),
    "ae": _edge_set(["ae"], 1),
    "ae_normed_alone": _edge_set(["ae_normed"], 1),
    "ae_tracking_1": _edge_set(["ae_tracking_1"], 1),
}


def variant(name: str, base=None):
    """``base`` (the model_58_4 preset when None) with the delta ``name`` (a
    key of :data:`VARIANTS` or :data:`VARIANT_CUTS`) merged over it."""
    cfg = w32_512_train() if base is None else base
    cfg.merge_from_other({**VARIANTS, **VARIANT_CUTS}[name])
    return cfg


# A narrow HigherHRNet (widths 8-32, one block per branch) at 64x64 with the
# flagship MPN widths, K = 8 detections per type and 3 MPN steps: the size
# the CPU parity tests and the card's CPU-against-card checks run at. K = 8
# keeps 17 * K a multiple of 8, which the JAX package's Pallas tiling needs
# (pemp_tpu.models.mpn.layers.fused_tile_ok); otherwise the JAX side would
# take its unfused path.
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


def small_train():
    """:data:`MODEL_58_4` cut to :data:`SMALL`'s size: 64x64 input with
    output maps of 16 and 32, batch 2."""
    cfg = w32_512_train()
    cfg.merge_from_other(SMALL)
    cfg.merge_from_other({"DATASET": {"INPUT_SIZE": 64, "OUTPUT_SIZE": [16, 32]},
                          "TRAIN": {"BATCH_SIZE": 2}})
    return cfg


def small_81_1_2():
    """:data:`MODEL_81_1_2` cut to :data:`SMALL`'s size: 64x64 input with
    output maps of 16 and 32, batch 2, 14 joint types (14 * K = 112 keeps
    the JAX package's Pallas tiling)."""
    cfg = model_81_1_2()
    cfg.merge_from_other(SMALL)
    cfg.merge_from_other({"DATASET": {"INPUT_SIZE": 64, "OUTPUT_SIZE": [16, 32]},
                          "TRAIN": {"BATCH_SIZE": 2}})
    return cfg


# tests/test_overfit.py:42-67's cut of model_58_4, where the JAX package
# learns one fixed batch (edge and node precision and recall and class
# accuracy 0.9 within 400 iterations): a one-stack Hourglass 32 wide at
# 64x64 with output maps of 16, 3 MPN steps, K = 6, kNN k = 8, the greedy
# matcher and the edge, node and class losses.
OVERFIT = {
    "MODEL": {"KP": "hourglass", "HG": {"NSTACK": 1, "INPUT_DIM": 32, "OUTPUT_DIM": 48},
              "MPN": {"STEPS": 3, "NODE_INPUT_DIM": 64},
              "LOSS": {"NAME": ["edge", "node", "class"]}},
    "TPU": {"NODES_PER_TYPE": 6, "KNN_K": 8, "MATCHER": "greedy"},
    "TRAIN": {"END_TO_END": True, "KP_FREEZE_MODE": "nothing"},
    "DATASET": {"INPUT_SIZE": 64, "OUTPUT_SIZE": [16, 16]},
}


def overfit_cut():
    """:data:`MODEL_58_4` cut to :data:`OVERFIT`."""
    cfg = w32_512_train()
    cfg.merge_from_other(OVERFIT)
    return cfg


# The Hourglass at 512 cut in width and depth: 2 stacks 16 wide (the stem's
# fixed 64 and 128 channels and the nested blocks' 128 more each level
# stay). The long-side reverse map holds the input at 512.
SMALL_HG = {"MODEL": {"HG": {"NSTACK": 2, "INPUT_DIM": 16}},
            "DATASET": {"OUTPUT_SIZE": [128, 128]}}


def small_hg():
    """:data:`HG_512` cut to :data:`SMALL_HG`'s size."""
    cfg = hg_512()
    cfg.merge_from_other(SMALL_HG)
    return cfg
