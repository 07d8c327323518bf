"""PyTorch/CUDA port of cosdata_tpu's dense u8 exact-scan search.

Module names mirror ``cosdata_tpu`` so each counterpart is easy to find.
The package imports torch and numpy only, never jax and never
``cosdata_tpu`` (whose ``__init__`` imports jax). Every index and store
takes an explicit ``device``: CPU tensors take each kernel's plain PyTorch
version, CUDA tensors take the hand-written kernel or raise.
"""
