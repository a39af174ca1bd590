"""summerset_tpu_torch — the PyTorch/CUDA port of the batched lockstep
SMR engine, for NVIDIA Hopper (H100).

The JAX package ``summerset_tpu`` stays the reference; this package keeps
its layout so every counterpart is easy to find:

- ``ops``        — per-(group, replica) LCG PRNG, GF(2^8) Reed-Solomon codec
                   whose bit-sliced matrix product is a hand-written CUDA
                   kernel (``csrc/bitslice.cu``)
- ``core``       — protocol SPI, telemetry lanes, quorum tally, network
                   model, tick engine
- ``protocols``  — the vectorized MultiPaxos, RSPaxos, Raft, CRaft and
                   Crossword kernels
- ``host``       — the codeword payload store
- ``entry``      — one flagship tick (1024 groups x 5 replicas)
- ``convert``    — JAX-state (numpy) <-> port-state (torch) conversion

Rules: the package imports ``torch`` and numpy, never ``jax`` nor any
module of ``summerset_tpu``.  State is a dict of int32/bool tensors; every
uint32 lane of the JAX state is held as int32 with the same bits.  Every
entry point takes ``device`` (default ``"cuda"``) and raises when no card
is present unless the caller passed ``device="cpu"``.
"""
