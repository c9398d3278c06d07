"""fss_tpu_torch: the PyTorch/CUDA port of fss_tpu for NVIDIA Hopper.

The DPF, DCF, Half-Tree DPF and verifiable DPF schemes with the ChaCha or
AES-128-MMO PRG (Gen, point Eval, EvalAll; the VDPF's proofs with keyed
BLAKE3 or SHA-256), over Bytes and Uint output groups, bit-exact with
``fss_tpu`` and the reference's wire formats. Their hot loops are
hand-written CUDA kernels (``csrc/``), built by nvcc at first use; every
kernel has a plain PyTorch version beside it, which the CPU path runs.

Entry points: ``fss_tpu_torch.api.Dpf``, ``Dcf``, ``HalfTreeDpf`` and
``Vdpf``.
"""
