"""PyTorch + CUDA port of the InfiniLoRA serving path for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: it imports torch and
numpy only, keeps the reference's tensor layouts at its public functions,
and replaces each TPU kernel on the ported path by a CUDA kernel written
for ``sm_90a`` (``csrc/``), each with a plain PyTorch twin that the CPU
runs and the card is checked against.
"""
