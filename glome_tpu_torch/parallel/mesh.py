"""Multi-process execution: rank meshes, ray sharding, gradient all-reduce.

Port of glome_tpu/parallel/mesh.py onto torch.distributed.  The
reference parallelizes with a shared-memory work-stealing scheduler over
65x65 image tiles (Glome.hs:379-386, monad-par); glome_tpu shards the
ray batch over a JAX device mesh with shard_map.  Here each rank is one
process: every rank holds the scene arrays and the global ray batch,
traces its contiguous slice of the rays, and the results are
all-gathered (render) or the per-rank parameter gradients all-reduced
(train step), so every rank ends with the same frame or the same new
arrays.

Mesh axes: 'dp' x 'sp' as in glome_tpu; both shard the ray axis (a
rank's slice is its position in the flattened mesh).  The backend is
NCCL for one rank per CUDA card and gloo for the CPU; ranks that share
one card pass backend="gloo", and their CUDA tensors cross the
collectives through host copies.

glome_tpu scales each shard's wavefront `min_tiles` floor by the mesh
size (_shard_tracer, mesh.py:83-97): that floor pads its static queue
capacities.  The port's queues are exact and no tracer reads
`min_tiles`, so a shard runs the caller's tracer as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..optimize import tree_leaves, tree_map
from ..graphs import EAGER
from ..trace import Tracer


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None):
    """Join the process group of `num_processes` ranks whose rank 0
    listens on `coordinator` ("host:port", e.g. "localhost:29500") as
    rank `process_id`.  backend None = "nccl" where CUDA is available
    (one card per rank: rank i takes card i), else "gloo".  No-op when
    num_processes is None (a single process needs no group)."""
    if num_processes is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None):
    """A 2D ('dp', 'sp') DeviceMesh over every rank of the process group
    (n_devices, if given, must be the world size); dp defaults to the
    largest factor of n not above sqrt(n), as in glome_tpu."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group "
                           "(call init_distributed first)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: a mesh spans every rank: n_devices "
                         f"{n}, world size {world}")
    if dp is None:
        dp = 1
        for f in range(int(math.isqrt(n)), 0, -1):
            if n % f == 0:
                dp = f
                break
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, n // dp),
                            mesh_dim_names=("dp", "sp"))


def shard_rays(n_rays: int, mesh) -> int:
    """Pad count so the ray axis divides the mesh size."""
    total = mesh.size()
    return ((n_rays + total - 1) // total) * total


def _shard(mesh, n: int) -> slice:
    """This rank's contiguous slice of n rays: its position in the
    flattened ('dp', 'sp') mesh."""
    total = mesh.size()
    if n % total:
        raise ValueError(f"{n} rays do not split over {total} ranks "
                         f"(pad with shard_rays)")
    dp_i, sp_i = mesh.get_coordinate()
    k = dp_i * mesh.size(1) + sp_i
    s = n // total
    return slice(k * s, (k + 1) * s)


def _host_staged(t):
    """A tensor the backend's collectives take: gloo gets a CPU copy of
    a CUDA tensor."""
    if t.is_cuda and dist.get_backend() != "nccl":
        return t.cpu()
    return t


def _all_gather(x, mesh):
    """The shards of every rank, concatenated in mesh order."""
    xs = _host_staged(x.contiguous())
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, xs)
    order = mesh.mesh.flatten().tolist()       # rank of each shard
    return torch.cat([parts[r] for r in order]).to(x.device)


def _all_reduce_sum(x):
    xs = _host_staged(x)
    dist.all_reduce(xs, op=dist.ReduceOp.SUM)
    return xs.to(x.device)


def sharded_render_fn(tracer: Tracer, mesh):
    """fn(arrays, o, d) -> (rgb, t) over the global rays (o, d: (N, 3),
    N a multiple of the mesh size): this rank traces its slice, and every
    rank returns the full (N, 3) premultiplied rgb and (N,) depth."""

    @torch.no_grad()
    def render(arrays, o, d):
        sl = _shard(mesh, o.shape[0])
        res = tracer.trace(arrays, o[sl], d[sl])
        rgb = res.color[..., :3] * res.color[..., 3:4]
        return _all_gather(rgb, mesh), _all_gather(res.t, mesh)

    return render


def sharded_train_step_fn(tracer: Tracer, mesh, lr: float = 1e-2):
    """One optimization step of the differentiable renderer: this rank's
    pixel squared error against its slice of the target (summed, divided
    by the global ray count), the gradients of every floating leaf of
    `arrays` all-reduced (SUM) with the loss over the mesh, then an SGD
    step, so every rank returns the same (new_arrays, loss).  This is
    the analog of glome_tpu's psum'd shard_map step (BASELINE.json
    config 5's gradient path)."""

    def step(arrays, o, d, target_rgb):
        n_global = o.shape[0]
        sl = _shard(mesh, n_global)
        params = tree_map(lambda p: p.detach().clone().requires_grad_(
            p.is_floating_point()), arrays)
        # the step's gradient needs the eager frame
        res = tracer.trace(params, o[sl], d[sl], frame=EAGER)
        rgb = res.color[..., :3] * res.color[..., 3:4]
        loss = torch.sum((rgb - target_rgb[sl]) ** 2) / n_global
        loss.backward()
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        flat = _all_reduce_sum(torch.cat(
            [g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]))
        it = iter(torch.split(flat[:-1], [p.numel() for p in leaves]))

        def update(p):
            if not p.requires_grad:
                return p.detach()
            return (p - lr * next(it).reshape(p.shape)).detach()
        return tree_map(update, params), flat[-1]

    return step
