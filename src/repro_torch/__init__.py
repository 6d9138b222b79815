"""B-PASTE on PyTorch and CUDA: the serving path of ``repro`` for NVIDIA Hopper.

Mirrors ``repro``'s module layout. Imports torch and numpy, never jax and
nothing of ``repro``; framework-free modules are kept as copies. Entry
points run on ``device="cuda"`` unless the caller passes another device.
"""
