"""cdlnet_tpu — convolutional dictionary learning (CDLNet) framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
RQLuo/CDLNet-video (reference layout documented in SURVEY.md): interpretable
image/video denoising via K-iteration unrolled ISTA (LISTA) over learned
convolutional dictionaries, with noise-adaptive soft thresholds.

Layers (see SURVEY.md §7):
  core/     pure math primitives (pad, ST, prox, power method, gabor, wavelets)
  ops/      conv/conv-transpose with reference semantics + lista_unroll scans
  models/   CDLNet, CDLNetVideo, GDLNet, CDLNet_CSR(f2), DnCNN, FFDNet
  nle/      blind noise-level estimation (MAD, PCA)
  data/     image/video/fastMRI pipelines, noise, synthetic fixtures
  train/    generic fit() with backtracking, MC-SURE, losses, checkpoints
  dist/     mesh/sharding: batch DP, depth-axis halo sharding
  compat/   PyTorch checkpoint import (reference trained_nets/*)
  cli/      train/analyze entry points accepting the reference args.json schema
"""

__version__ = "0.1.0"
