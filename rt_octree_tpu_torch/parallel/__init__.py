"""Multi-device rendering and training on torch.distributed
(rt_octree_tpu/parallel twin).

``launch`` starts one process a rank and rendezvouses them; ``mesh``
holds the JAX package's entry points on a ``("dp", "sp")`` DeviceMesh:
``make_mesh``, ``make_sharded_ray_tracer`` and ``render_rays_sharded``
(a ray batch split over the ranks), ``make_sharded_frame_renderer`` (the
frame in row bands, one a rank) and ``make_sharded_train_step`` (batch
over dp, image rows over sp, gradients averaged by
DistributedDataParallel).
"""
