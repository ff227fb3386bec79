"""The port's hand-written kernels, each behind a wrapper that launches it
on CUDA tensors and runs its plain PyTorch version on CPU tensors. A
wrapper adds one to its kernel's launch counter where it launches the
kernel, and nowhere else; :func:`launch_counts` reads the counters."""

import importlib

# each kernel's launch counter: {kernel: (module of this package, attribute)}
LAUNCH_COUNTERS = {
    "K1": ("fused_step", "LAUNCHES"),
    "K2": ("typed_message", "LAUNCHES_FWD"),
    "K2b": ("typed_message", "LAUNCHES_BWD"),
    "K3": ("attn_aggregate", "LAUNCHES_FWD"),
    "K3b": ("attn_aggregate", "LAUNCHES_BWD"),
    "K4": ("blocked_attn", "LAUNCHES"),
    "K4b": ("blocked_attn", "LAUNCHES_BWD"),
    "G1": ("gather_mm", "LAUNCHES"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """Each kernel's launches since the process started or since
    :func:`zero_launch_counts`."""
    return {k: getattr(_module(m), attr) for k, (m, attr) in LAUNCH_COUNTERS.items()}


def zero_launch_counts() -> None:
    for m, attr in LAUNCH_COUNTERS.values():
        setattr(_module(m), attr, 0)
