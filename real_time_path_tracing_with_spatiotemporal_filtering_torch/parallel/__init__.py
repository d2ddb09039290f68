"""Row-sharded execution over ``torch.distributed``.

The reference is strictly single-GPU. The port's scaling story is the JAX
package's (its parallel/ over a TPU mesh): shard the pixel rows of the frame
across the ranks of a process group, exchange the a-trous stencil halos
between row neighbours point to point, and reproject the history through a
small row window, all-gathering only when the motion leaves it
(:mod:`.sharding`, :mod:`.frame_sharded`).
"""
