"""halo2_tpu_torch: the PyTorch/CUDA port of the halo2_tpu prover.

A Halo2-class PLONKish prover over the Pasta curves whose O(n) work runs
on an NVIDIA GPU through hand-written CUDA kernels (csrc/). The JAX
package halo2_tpu is the reference it is tested against; this package
imports nothing of it (nor of JAX) and keeps its own copy of every host
module it needs.

Entry points take a `device`: they run on "cuda" unless the caller asks
for "cpu", where every kernel wrapper takes its plain PyTorch version.
"""
