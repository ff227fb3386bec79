"""PyTorch + CUDA port of pemp_tpu for one NVIDIA H100.

Imports torch and numpy only, never jax, flax or pemp_tpu. Entry points:
:func:`pemp_tpu_torch.pipeline.build_pipeline` and
:func:`pemp_tpu_torch.models.pose_estimation.build_pose_model`.
"""
