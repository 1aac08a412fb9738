"""Photon data parallelism over shards and processes.

Counterpart of flatmatch_tpu/parallel/mesh.py. The JAX package shards over
a 1-D `photons` mesh of devices with shard_map and combines with psum. Here
a mesh is this process's list of shard devices (a device may repeat:
`photon_mesh(["cuda:0"] * 4)` is four shards on one card, which run the
same per-shard work and combine as four cards, in series), times the
processes of the group (parallel/multihost.py). Shard `ax` of this process
is global shard process_index * local count + i.

- The scene tables and the lightmap are replicated: each shard device
  holds its own copy, and each shard traces its slice of every batch,
  keyed by (batch, shard), into a partial of its own.
- `PhotonMesh.combine` adds the partials in global shard order, one after
  another (acc = acc + p[ax]), in place of psum; across processes it
  all-gathers the stacked local partials on the host first. Elementwise
  float32 adds round alike on any device, so a render's bits depend on
  the shard count only, not on how the shards are spread over processes
  or cards; against the JAX package's psum they agree to a tolerance.
- The kernels are the single-device engines' (engines/photon_wide.py,
  engines/photon.py, engines/ao.py, engines/radiosity.py): their wrappers
  launch on the device of the tensors they are given, on its current
  stream, with per-device scratch, so the shards' launches interleave
  batch by batch and distinct cards overlap.

Results are bit-deterministic for a fixed (seed, shard count).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AoConfig, PhotonConfig
from ..engines import ao
from ..engines import photon_wide as pw
from ..ops import threefry
from ..ops.aa_scene import AARects
from ..ops.device_scene import Emitters, Rects
from ..scene.geometry import Scene
from ..utils.spans import span
from . import multihost

LANES = pw.LANES


@dataclasses.dataclass(frozen=True)
class PhotonMesh:
    """This process's shard devices within the group's global shards."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def local_count(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Global shard count: processes x local shards."""
        return self.process_count * len(self.devices)

    def shards(self) -> List[Tuple[int, torch.device]]:
        """(global shard index, device) of each local shard, in order."""
        first = self.process_index * len(self.devices)
        return [(first + i, d) for i, d in enumerate(self.devices)]

    def _everyone(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor in global shard order: the local ones, or
        across processes the all-gather of the stacked local ones (on the
        host, where gloo carries them)."""
        if len(parts) != len(self.devices):
            raise ValueError(f"{len(parts)} partials for "
                             f"{len(self.devices)} local shards")
        if self.process_count == 1:
            return list(parts)
        import torch.distributed as dist

        stacked = torch.stack([p.detach().cpu() for p in parts])
        out = [torch.empty_like(stacked) for _ in range(self.process_count)]
        dist.all_gather(out, stacked)
        return [p for s in out for p in s.unbind(0)]

    def combine(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's partial (equal shapes), added in global
        shard order one after another, on the first local partial's
        device."""
        with span("mesh.combine"):
            dev = partials[0].device
            acc = None
            for p in self._everyone(partials):
                acc = (p.to(dev, copy=True) if acc is None
                       else acc + p.to(dev))
            return acc

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's part (equal shapes) concatenated along dim 0 in
        global shard order, on the first local part's device."""
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in self._everyone(parts)])


def photon_mesh(devices=None) -> PhotonMesh:
    """The mesh over `devices` (this process's shards; by default every
    visible CUDA device), times the processes of the group. Every process
    must hold as many shards: the count is checked across the group."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: give photon_mesh "
                               "its devices, e.g. ['cpu'] * 4")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    count = multihost.process_count()
    if count > 1:
        import torch.distributed as dist

        local = torch.tensor([len(devs)])
        everyone = [torch.empty_like(local) for _ in range(count)]
        dist.all_gather(everyone, local)
        if any(int(c) != len(devs) for c in everyone):
            raise ValueError(
                f"every process must hold the same number of shards; the "
                f"group holds {[int(c) for c in everyone]}")
    return PhotonMesh(tuple(devs), multihost.process_index(), count)


def to_device(t, dev):
    """A NamedTuple of tensors (a scene table, emitters) on `dev`."""
    return type(t)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                     for x in t))


def per_device(mesh: PhotonMesh, make):
    """make(device) once per distinct device of the local shards."""
    out = {}
    for _, dev in mesh.shards():
        if dev not in out:
            out[dev] = make(dev)
    return out


def local_valid(n_valid_global: int, ax: int, b_local: int) -> int:
    """Live photons of shard ax's slice [ax * b_local, (ax + 1) * b_local)
    of a global batch (mesh.py:90-93)."""
    return min(max(int(n_valid_global) - ax * b_local, 0), b_local)


def sharded_batch(cfg: PhotonConfig, n: int, quantum: int = 1) -> int:
    """The global batch of an n-shard render: cfg's rounded up to a
    multiple of n * quantum, so each shard traces batch // n photons."""
    q = n * quantum
    return -(-int(cfg.photons_per_batch) // q) * q


def _run(mesh: PhotonMesh, shards, emitters: Emitters, num_texels: int,
         cfg: PhotonConfig, checkpoint_path, fingerprint_extra,
         on_segment) -> torch.Tensor:
    """The emitter schedule through `schedule.run_schedule`, each batch
    traced by every shard's step(partial, e, gb, n_valid_global) into its
    own partial. Straight, the partials are combined once, at the end;
    with `checkpoint_path` or `on_segment`, into the lightmap after every
    segment, so a checkpointed, previewed or resumed render ends on the
    same bits as any other at that segment length. Only the primary
    process writes checkpoints. The lightmap lies on the emitters'
    device."""
    from ..engines.schedule import run_schedule

    parts = [torch.zeros((num_texels, 3), dtype=torch.float32, device=d)
             for _, d in mesh.shards()]

    def step(lm, e, gb, n_valid, bsz):
        for sh, part in zip(shards, parts):
            sh(part, e, gb, n_valid)

    def end_segment(lm):
        lm += mesh.combine(parts).to(lm.device)
        for part in parts:
            part.zero_()

    segmented = checkpoint_path is not None or on_segment is not None
    lm = run_schedule(step, emitters, num_texels, cfg, None,
                      checkpoint_path, fingerprint_extra, on_segment,
                      write_checkpoints=multihost.is_primary(),
                      end_segment=end_segment if segmented else None)
    return lm if segmented else mesh.combine(parts).to(lm.device)


def render_photons_sharded_wide(
    emitters: Emitters, num_texels: int, cfg: PhotonConfig, aa: AARects,
    mesh: Optional[PhotonMesh] = None, checkpoint_path: str = None,
    on_segment=None,
) -> torch.Tensor:
    """The axis-aligned photon render (engines/photon_wide.py, every splat
    and either draw source) sharded over the mesh: the raw [num_texels, 3]
    lightmap on the emitters' device (mesh.py:317-407).

    The global batch B is cfg's rounded up to a multiple of shards x 128;
    shard ax traces photons [ax * B/n, (ax + 1) * B/n) of every global
    batch, with the counter-hash seed device_seed(batch_seed(seed, gb), ax)
    or the threefry key fold_in(fold_in(PRNGKey(seed), gb), ax). A tail
    batch runs on the local grid that covers shard 0's live photons
    (`tail_batch_size`); a shard with none left skips it (it would add
    +0.0). The schedule and its combines are `_run`'s. The checkpoint's
    fingerprint carries the shard count: a resume with another count is
    refused."""
    mesh = mesh or photon_mesh()
    n = mesh.size
    B = sharded_batch(cfg, n, LANES)
    b_local = B // n
    cfg = dataclasses.replace(cfg, photons_per_batch=B)
    pw.check_port_cfg(cfg)
    if cfg.splat in ("inkernel_i8", "fused_i8"):
        pw.check_i8_accumulator(cfg, b_local)
    with span("engine.tables"):
        aa_c, total_c, expand = pw.compact_aa(aa, num_texels)
        fields = per_device(mesh, lambda d: aa_c.fields.to(d))
    shards = []
    for ax, dev in mesh.shards():
        step, quantum = pw.batch_step(fields[dev], aa_c.group_counts,
                                      emitters, cfg, total_c, b_local, ax)

        def shard(part, e, gb, n_valid, ax=ax, step=step, quantum=quantum):
            nv = local_valid(n_valid, ax, b_local)
            if nv:
                bsz = (b_local if n_valid >= B else pw.tail_batch_size(
                    min(b_local, n_valid), b_local, quantum))
                step(part, e, gb, nv, bsz)

        shards.append(shard)

    seg_cb = None
    if on_segment is not None:
        def seg_cb(lm, done, total):
            on_segment(expand(lm), done, total)

    compact = _run(mesh, shards, emitters, total_c, cfg, checkpoint_path,
                   ("wide-sharded", "compact", n), seg_cb)
    with span("engine.readback"):
        return expand(compact)


def render_photons_sharded(
    rects: Rects, emitters: Emitters, num_texels: int, cfg: PhotonConfig,
    mesh: Optional[PhotonMesh] = None, checkpoint_path: str = None,
    on_segment=None,
) -> torch.Tensor:
    """The general photon engine (engines/photon.py) sharded over the mesh
    (mesh.py:592-631): the global batch is cfg's rounded up to a multiple
    of the shard count, and shard ax traces its B/n photons of every
    global batch on the uniforms of fold_in(fold_in(PRNGKey(seed), gb),
    ax), into its partial. The schedule and its combines are `_run`'s; the
    fingerprint carries the shard count."""
    from ..engines import photon
    from ..engines.schedule import emitter_slice

    mesh = mesh or photon_mesh()
    n = mesh.size
    B = sharded_batch(cfg, n)
    b_local = B // n
    cfg = dataclasses.replace(cfg, photons_per_batch=B)
    U = pw.uniforms_per_photon(cfg.max_depth)
    with span("engine.tables"):
        tables = per_device(mesh, lambda d: (to_device(rects, d),
                                              to_device(emitters, d)))
    slices = {}
    shards = []
    for ax, dev in mesh.shards():
        def shard(part, e, gb, n_valid, ax=ax, dev=dev):
            nv = local_valid(n_valid, ax, b_local)
            if not nv:
                return
            if (dev, e) not in slices:
                slices[dev, e] = emitter_slice(tables[dev][1], e)
            u = threefry.batch_uniforms(cfg.seed, gb, b_local, U, dev,
                                        shard=ax)
            photon.trace_batch(part, tables[dev][0], slices[dev, e], u, nv,
                               cfg)

        shards.append(shard)
    return _run(mesh, shards, emitters, num_texels, cfg, checkpoint_path,
                ("xla-sharded", n), on_segment)


def _padded_rows(total: int, n: int) -> Tuple[int, np.ndarray]:
    """(rows per shard, row index of each padded row): `total` rows padded
    to a multiple of n by replaying the first rows."""
    per = -(-total // n)
    return per, np.arange(per * n) % total


def render_ao_fused_sharded(scene: Scene, aa: AARects, cfg: AoConfig,
                            mesh: Optional[PhotonMesh] = None) -> np.ndarray:
    """The fused AO pass (engines/ao.render_ao_fused, `csrc/ao_fused.cu`)
    sharded over the mesh (mesh.py:410-479). AO is texel-parallel: each
    texel's sum is made by one block of the kernel on its own, so the
    texel rows divide across shards, each shard running the kernel over
    its slice against its replica of the table and the direction rows.
    The padding to a multiple of the shard count replays the first rows
    (block 0); its sums are cut off before `ao_fused_write_back`. No sum
    crosses a shard: the shards' sums are gathered in shard order (across
    processes through the group), so the arena equals the single-device
    pass bit for bit."""
    mesh = mesh or photon_mesh()
    centers, wall_ids, dirs, fac, gather_idx, norm = ao._ao_fused_prep(
        scene, cfg)
    T = len(centers)
    per, rows = _padded_rows(T, mesh.size)
    shared = per_device(mesh, lambda d: (
        aa.fields.to(d), torch.from_numpy(dirs).to(d),
        torch.from_numpy(fac).to(d)))
    sums = []
    for ax, dev in mesh.shards():
        fields, dirs_d, fac_d = shared[dev]
        sl = rows[ax * per:(ax + 1) * per]
        sums.append(ao.ao_fused(
            fields, aa.group_counts, torch.from_numpy(centers[sl]).to(dev),
            torch.from_numpy(wall_ids[sl]).to(dev), dirs_d, fac_d,
            float(cfg.sky_distance)))
    out = mesh.gather(sums).cpu().numpy()[:T]
    return ao.ao_fused_write_back(scene, out, gather_idx, norm)


def render_ao_sharded(scene: Scene, aa: AARects, cfg: AoConfig,
                      mesh: Optional[PhotonMesh] = None) -> np.ndarray:
    """The chunked AO pass (engines/ao.render_ao, `nearest_distances` of
    `csrc/aa_nearest.cu`) sharded over the mesh (mesh.py:482-589): the
    level-0 texel axis wrap-padded to a multiple of the shard count, each
    shard's slice through the single-device pass's own loop
    (`ao.chunked_values`), the values gathered in shard order. Each
    texel's value is made as on one device, so the two agree bit for bit
    wherever the device's row sum takes the same order for both chunkings
    (on the CPU always)."""
    mesh = mesh or photon_mesh()
    centers, walls, dirs, fac = ao.chunked_tables(scene, cfg)
    T0 = len(centers)
    per, rows = _padded_rows(T0, mesh.size)
    shared = per_device(mesh, lambda d: (
        aa.fields.to(d), torch.from_numpy(dirs).to(d),
        torch.from_numpy(fac).to(d)))
    vals = []
    for ax, dev in mesh.shards():
        fields, dirs_d, fac_d = shared[dev]
        sl = rows[ax * per:(ax + 1) * per]
        vals.append(ao.chunked_values(
            fields, aa.group_counts, torch.from_numpy(centers[sl]).to(dev),
            torch.from_numpy(walls[sl]).to(dev), dirs_d, fac_d, cfg))
    return ao.level0_write_back(scene, mesh.gather(vals).cpu().numpy()[:T0])
