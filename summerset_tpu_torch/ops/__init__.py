"""Device ops: per-group LCG PRNG and the GF(2^8) Reed-Solomon codec with
its hand-written CUDA kernel."""
