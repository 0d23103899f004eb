"""Multi-rank runs for ``tests/test_torch_distributed.py``, each in its own
process, reading the test's inputs from ``DIR/inputs.npz`` and the
reference's checkpoint from ``DIR/ckpt``:

  python tests/_torch_dist_helper.py ref DIR
      the reference on 4 host devices (the test sets
      XLA_FLAGS=--xla_force_host_platform_device_count=4): writes
      DIR/ref.npz
  python tests/_torch_dist_helper.py port DIR RANK WORLD
      one rank of the port over gloo (a FileStore in DIR): writes
      DIR/port_RANK.npz

Both run the same work on a (2, 2) ("data", "model") mesh and a 4-stage
("stage",) one: the sharded embedding (tied and untied, fp32 and bf16,
forward and the table's gradient), int8 error-feedback all-reduce over each
axis, the GPipe schedule (S 4, M 6; the reference also at S 2 and with its
mesh's devices reversed), and elastic restore of the checkpoint onto
``param_specs`` with flat DP (each mesh position's shard).
"""

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, ROOT)

DTYPES = ("float32", "bfloat16")
AXES = ("data", "model")
S_STAGES, M_MICRO = 4, 6


def _paths(tree, prefix=""):
    """(path, leaf) pairs of nested dicts, "/"-joined."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


# ---------------------------------------------------------------- reference
def run_ref(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.checkpoint.manager import CheckpointManager
    from repro.distributed import sharding as shd
    from repro.distributed.grad_compression import compressed_psum
    from repro.distributed.pipeline import pipeline_forward
    from repro.launch.mesh import make_host_mesh
    from repro.models.common import embed_lookup, set_mesh_hint

    inp = np.load(os.path.join(d, "inputs.npz"))
    devs = jax.devices()
    assert len(devs) == 4, devs
    mesh = Mesh(np.array(devs).reshape(2, 2), AXES)
    out = {"host_mesh_8x8": np.array(
        make_host_mesh(data=8, model=8).devices.shape)}

    # the sharded embedding (each program jitted: eager shard_map compiles
    # every primitive on its own)
    set_mesh_hint(mesh)
    for tied in (True, False):
        for dt in DTYPES:
            @jax.jit
            def lookup(t, g, tied=tied):
                x, vjp = jax.vjp(
                    lambda t: embed_lookup(t, inp["tokens"], tied), t)
                return x, vjp(g)[0]
            x, gt = lookup(jnp.asarray(inp["table"], dt),
                           jnp.asarray(inp["g"], dt))
            out[f"embed_x_{tied}_{dt}"] = np.asarray(x, np.float32)
            out[f"embed_grad_{tied}_{dt}"] = np.asarray(gt, np.float32)
    set_mesh_hint(None)

    # int8 error-feedback all-reduce: device (i, j) holds row 2 i + j
    spec = P(AXES)
    for axis in AXES:
        def f(x, e, axis=axis):
            r, ne = compressed_psum(x[0], axis, error=e[0])
            return r[None], ne[None]
        # eager: under jit XLA fuses x - q s and rounds it once, where the
        # function as written (and the port) rounds the product first
        red, err = shard_map(f, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec), check_rep=False)(
            inp["gc_x"], inp["gc_err"])
        out[f"gc_reduced_{axis}"] = np.asarray(red)
        out[f"gc_error_{axis}"] = np.asarray(err)

    # the GPipe schedule
    def layer(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    params = {"w": inp["pipe_w"], "b": inp["pipe_b"]}
    for S, reverse in ((S_STAGES, True), (S_STAGES, False), (2, False)):
        order = devs[:S][::-1] if reverse else devs[:S]
        pmesh = Mesh(np.array(order), ("stage",))
        xs = inp["pipe_xs"][:, :, :]
        sp = {k: v[:S] for k, v in params.items()}
        y = jax.jit(pipeline_forward(layer, S, xs.shape[0], pmesh))(sp, xs)
        last = [s for s in y.addressable_shards
                if s.device == pmesh.devices[S - 1]]
        tag = f"{S}_{'reversed' if reverse else 'inorder'}"
        out[f"pipe_returned_{tag}"] = np.asarray(y)
        out[f"pipe_last_stage_{tag}"] = np.asarray(last[0].data)

    # elastic restore onto param_specs with flat DP
    shd.set_flat_dp(True)
    mgr = CheckpointManager(os.path.join(d, "ckpt"))
    _, plain = mgr.restore()
    pspecs = shd.param_specs(mesh, plain["params"])
    _, placed = mgr.restore(shardings={
        "params": shd.shardings(mesh, pspecs)})
    flat_devs = list(mesh.devices.flat)
    for path, leaf in _paths(placed["params"]):
        for s in leaf.addressable_shards:
            raw = np.ascontiguousarray(np.asarray(s.data)).view(np.uint8)
            out[f"ckpt/{path}@{flat_devs.index(s.device)}"] = raw
    for path, spec in jax.tree_util.tree_flatten_with_path(
            pspecs, is_leaf=lambda x: isinstance(x, P))[0]:
        canon = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                      for e in spec)
        out[f"ckpt_spec/{shd._path_str(path)}"] = np.array(repr(canon))
    shd.set_flat_dp(False)
    np.savez(os.path.join(d, "ref.npz"), **out)


# --------------------------------------------------------------------- port
def run_port(d: str, rank: int, world: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.grad_compression import (
        compressed_psum, dequantize_int8, quantize_int8, tree_compressed_psum)
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import (embed_lookup, set_mesh_hint,
                                           shard_hint)

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    inp = np.load(os.path.join(d, "inputs.npz"))
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    out = {"host_mesh_8x8": np.array(
        make_host_mesh(data=8, model=8, device="cpu").shape),
        "coordinate": np.array(mesh.get_coordinate())}

    def dt_of(name):
        return getattr(torch, name)

    # the sharded embedding: table and tokens as DTensors on their specs
    set_mesh_hint(mesh)
    tokens_full = torch.from_numpy(inp["tokens"])
    V, dm = inp["table"].shape
    for tied in (True, False):
        for dt in DTYPES:
            tspec = (shd.fit(mesh, (V, dm), "model", None) if tied
                     else shd.fit(mesh, (V, dm), None, "model"))
            table = distribute_tensor(
                torch.from_numpy(inp["table"]).to(dt_of(dt)), mesh,
                shd.placements(mesh, tspec)).requires_grad_()
            tokens = distribute_tensor(tokens_full, mesh, shd.placements(
                mesh, shd.fit(mesh, tuple(tokens_full.shape),
                              shd.dp_axes(mesh), None)))
            x = embed_lookup(table, tokens, tied)
            g = distribute_tensor(torch.from_numpy(inp["g"]).to(dt_of(dt)),
                                  mesh, x.placements)
            x.backward(g)
            out[f"embed_x_{tied}_{dt}"] = \
                x.full_tensor().detach().float().numpy()
            out[f"embed_grad_{tied}_{dt}"] = \
                table.grad.full_tensor().float().numpy()
            out[f"embed_x_placements_{tied}_{dt}"] = np.array(
                repr(tuple(x.placements)))
    # a DTensor is redistributed to the hinted spec; a plain tensor over
    # an axis of size 2 is refused; with no hint, a tensor is returned
    full = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    xd = distribute_tensor(full, mesh, shd.placements(
        mesh, shd.fit(mesh, (4, 8, 6), None, "data", None)))
    hinted = shard_hint(xd, "dp", None, "model")
    out["shard_hint_dtensor_placements"] = np.array(
        repr(tuple(hinted.placements)))
    out["shard_hint_dtensor_same"] = np.array(
        torch.equal(hinted.full_tensor(), full))
    try:
        shard_hint(torch.zeros(4, 8), "dp", None)
        out["shard_hint_plain_raised"] = np.array("")
    except ValueError as e:
        out["shard_hint_plain_raised"] = np.array(str(e))
    set_mesh_hint(None)
    z = torch.zeros(4, 8)
    out["shard_hint_no_hint_is_input"] = np.array(shard_hint(z, "dp", None)
                                                  is z)

    # int8 error-feedback all-reduce over each axis of the mesh
    x = torch.from_numpy(inp["gc_x"][rank])
    e = torch.from_numpy(inp["gc_err"][rank])
    for axis in AXES:
        red, ne = compressed_psum(x, mesh.get_group(axis), error=e)
        out[f"gc_reduced_{axis}"] = red.numpy()
        out[f"gc_error_{axis}"] = ne.numpy()
    q, s = quantize_int8(x + e)
    out["gc_sent"] = dequantize_int8(q, s, x.shape).numpy()
    tree = {"a": x, "b": [x[:300].reshape(3, 100)]}
    errs = {"a": e, "b": [e[:300].reshape(3, 100)]}
    red_t, err_t = tree_compressed_psum(tree, mesh.get_group("data"), errs)
    red_b, err_b = compressed_psum(tree["b"][0], mesh.get_group("data"),
                                   error=errs["b"][0])
    out["gc_tree_same"] = np.array(
        torch.equal(red_t["a"], torch.from_numpy(out["gc_reduced_data"]))
        and torch.equal(err_t["a"], torch.from_numpy(out["gc_error_data"]))
        and torch.equal(red_t["b"][0], red_b)
        and torch.equal(err_t["b"][0], err_b))

    # the GPipe schedule: S 4 stages, one a rank, M 6 microbatches
    smesh = DeviceMesh("cpu", torch.arange(world),
                       mesh_dim_names=("stage",))

    def layer(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    params = {"w": torch.from_numpy(inp["pipe_w"]),
              "b": torch.from_numpy(inp["pipe_b"])}
    xs = torch.from_numpy(inp["pipe_xs"])
    y = pipeline_forward(layer, S_STAGES, M_MICRO, smesh)(params, xs)
    seq = []
    for m in range(M_MICRO):
        h = xs[m]
        for s in range(S_STAGES):
            h = layer({k: v[s] for k, v in params.items()}, h)
        seq.append(h)
    out["pipe_out"] = y.numpy()
    out["pipe_sequential"] = torch.stack(seq).numpy()

    # elastic restore onto param_specs with flat DP: one dim over both axes
    shd.set_flat_dp(True)
    mgr = CheckpointManager(os.path.join(d, "ckpt"))
    _, plain = mgr.restore(device="cpu")
    pspecs = shd.param_specs(mesh, plain["params"])
    _, placed = mgr.restore(device="cpu", shardings={
        "params": shd.shardings(mesh, pspecs)})
    for path, leaf in _paths(placed["params"]):
        local = leaf.to_local().contiguous()
        raw = (local.view(torch.int16) if local.dtype == torch.bfloat16
               else local).numpy().view(np.uint8).reshape(-1)
        out[f"ckpt/{path}"] = raw
    for path, spec in _paths(pspecs):
        out[f"ckpt_spec/{path}"] = np.array(repr(tuple(spec)))
    out["ckpt_step_device"] = np.array(str(placed["step"].device))
    out["ckpt_step_is_plain"] = np.array(
        not hasattr(placed["step"], "to_local"))
    shd.set_flat_dp(False)
    np.savez(os.path.join(d, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        run_ref(sys.argv[2])
    else:
        run_port(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
