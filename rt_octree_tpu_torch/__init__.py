"""rt_octree_tpu_torch: the RT-Octree renderer in PyTorch with hand-written
CUDA kernels for Hopper (sm_90a), beside the JAX reference package
``rt_octree_tpu``.

Layout mirrors the JAX package: ``ops`` (traversal with the LUT kernel K3,
the guided-filter kernel K2, basis functions), ``render`` (the fused frame
kernel K1 and the Renderer), ``models`` (GuidanceNet), ``io`` (.gnet and
PNG readers), ``utils`` (PCG32, the phase timer), ``apps`` (headless CLI),
``native`` (nvcc build, ctypes loading, launch counters) and ``csrc`` (the
CUDA sources).  The pure-NumPy host code (``core``: options, camera;
``io``: tree loading, poses, synthetic trees) is the port's own copy of the
JAX package's modules of the same names: the port imports nothing of
``rt_octree_tpu``.

Importing the package builds nothing and imports neither JAX nor Triton.
"""

import torch

# f32 exactness: the march and the shade are held to the reference at f32,
# and a float32 convolution or matmul on the card would otherwise run in
# TF32 (cuDNN's default), which keeps about three decimal digits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
