"""fss_tpu_torch: the PyTorch/CUDA port of fss_tpu for NVIDIA Hopper.

The DPF scheme with the ChaCha PRG (Gen, point Eval, EvalAll) over Bytes
and Uint output groups, bit-exact with ``fss_tpu`` and the reference's
wire formats. Its three hot loops are hand-written CUDA kernels
(``csrc/``), built by nvcc at first use; every kernel has a plain PyTorch
version beside it, which the CPU path runs.

Entry point: ``fss_tpu_torch.api.Dpf``.
"""
