"""RegionE in PyTorch with hand-written Hopper kernels.

The port of `regione_tpu` (JAX, the reference) to PyTorch and CUDA, module
for module: `models` (the MMDiT backbone, the Step1X connector, the
AutoencoderKL and Wan VAEs), `core` (masking, partition, the RegionE
sampler), `pipelines` (Step1X-Edit v1.1 / v1.2, FLUX.1 Kontext,
Qwen-Image-Edit and Plus: latent and image level), `cli` (the demo and
evaluation command line), `weights` (params from the JAX pytree or drawn anew)
and `ops` (the quantized KV-cache formats, and the CUDA kernels in `csrc/`,
each with its plain PyTorch version).  The numpy-only modules of the JAX
package (`core.{config,schedule,gamma}`, `api.RegionEHelper`, the CLI's
parser, `MockTextEncoder`) are shared by import.  Nothing here imports
JAX.
"""
