"""RegionE in PyTorch with hand-written Hopper kernels.

The port of `regione_tpu` (JAX, the reference) to PyTorch and CUDA, module
for module: `models` (the MMDiT backbone and the Step1X connector), `core`
(masking, partition, the RegionE sampler), `pipelines` (the latent-space
Step1X-Edit and Qwen-Image-Edit paths), `weights` (params from the JAX
pytree or drawn anew) and `ops` (the quantized KV-cache formats, and the CUDA
kernels in `csrc/`, each with its plain PyTorch version).
The numpy-only stage plan (`regione_tpu.core.{config,schedule,gamma}`) is
shared with the JAX package by import.  Nothing here imports JAX.
"""
