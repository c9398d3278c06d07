"""fss_tpu_torch: the PyTorch/CUDA port of fss_tpu for NVIDIA Hopper.

The six schemes, the DPF, DCF, Half-Tree DPF, Grotto DCF, verifiable DPF
and verifiable multi-point function (VDMPF), with the ChaCha or
AES-128-MMO PRG (Gen, point Eval, EvalAll; the VDPF's and VDMPF's proofs
with keyed BLAKE3 or SHA-256), over Bytes and Uint output groups,
bit-exact with ``fss_tpu`` and the reference's wire formats. Their hot
loops are hand-written CUDA kernels (``csrc/``), built by nvcc at first
use; every kernel has a plain PyTorch version beside it, which the CPU
path runs.

Entry points: ``fss_tpu_torch.api.Dpf``, ``Dcf``, ``HalfTreeDpf``,
``GrottoDcf``, ``Vdpf`` and ``Vdmpf``; ``fss_tpu_torch.parallel.mesh``
(data- and domain-sharded runs over ``torch.distributed``, ranks started
by torchrun or ``parallel.spawn``); ``fss_tpu_torch.crypto`` (the
fss_crypto-parity ``Dpf`` and ``Dcf`` on int32 tensors);
``fss_tpu_torch.native`` (the C++ host engine for every scheme, built by
g++ at first use); ``fss_tpu_torch.utils`` (``profile_trace``, and the
spans at the layers' boundaries, ``record``). ``samples/torch_*.py``
drive them as a user would.
"""
