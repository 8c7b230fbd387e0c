"""Spawned torch.distributed gloo groups for the port's multi-rank tests,
and the work each rank does.

`run(fn, world, tmp_path, *args)` starts `world` processes (spawn), joins
them into one gloo group over a `file://` store under tmp_path (no TCP
port, so parallel test workers cannot collide), calls fn(rank, world,
*args) in each and returns the ranks' results in rank order. A rank
that raises fails the call with its traceback; a group that has not
finished within `timeout` seconds is killed.

This module imports torch and the port only (never jax), so a spawned
rank starts in a few seconds; the tests compare the ranks' numbers with
JAX in the parent process.
"""
import multiprocessing as mp
import os
import queue
import time
import traceback


def _worker(rank, world, store, fn, args, q):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world))
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))


def run(fn, world, tmp_path, *args, timeout=150):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, store, fn, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, out = q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"gloo group of {world} did not finish "
                                   f"in {timeout} s (ranks done: "
                                   f"{sorted(results)})")
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------

def ring_rank(rank, world, cases):
    """For each case (q, k, v, q_pos, k_pos, g as numpy, full sequence):
    make_ring_attention's output (plain and zigzag) on a (1, world, 1)
    mesh, and ring_attention's output and q/k/v grads of vdot(out, g) on
    this rank's shards."""
    import numpy as np
    import torch
    from streamvln_tpu_torch.ops import ring_attention as ra
    from streamvln_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(dp=1, fsdp=world, tp=1)
    group = mesh.get_group("fsdp")
    out = {"dryrun": ra.ring_attention_dryrun(mesh),
           "sizes": [mesh_lib.mesh_shape(mesh_lib.make_mesh(**kw)) for kw in
                     (dict(), dict(dp=2), dict(tp=2, fsdp=1), dict(dp=2,
                                                                   tp=2))],
           "coord": mesh.get_coordinate()}
    for name, (q, k, v, qp, kp, g) in cases.items():
        t = [torch.from_numpy(x) for x in (q, k, v, qp, kp, g)]
        with torch.no_grad():
            plain = ra.make_ring_attention(mesh)(*t[:5])
            zz = ra.make_ring_attention(mesh, zigzag=True)(*t[:5])
        c = q.shape[1] // world
        sl = slice(rank * c, (rank + 1) * c)
        qs, ks, vs = (x[:, sl].clone().requires_grad_() for x in t[:3])
        o = ra.ring_attention(qs, ks, vs, t[3][:, sl], t[4][:, sl], group)
        (o * t[5][:, sl]).sum().backward()
        out[name] = {"plain": plain.numpy(), "zigzag": zz.numpy(),
                     "local": o.detach().numpy(),
                     "grads": [x.grad.numpy() for x in (qs, ks, vs)]}
    return out


# ---------------------------------------------------------------------------
# Train, DPO and the training command on a mesh
# ---------------------------------------------------------------------------

def _full_flat(params):
    """{path: numpy} of a (possibly DTensor) tree, gathered."""
    from streamvln_tpu_torch.parallel import mesh as mesh_lib
    from streamvln_tpu_torch.parallel.train import tree_leaves
    return {p: mesh_lib.full(t).detach().numpy()
            for p, t in tree_leaves(params)}


def train_rank(rank, world, cases):
    """For each case {"mesh": (dp, fsdp, tp), "cfg", "tcfg", "params"
    (numpy tree), "batches", optional "dpo": (ref numpy tree, beta)}:
    the port's step on that mesh over the batches; returns per case the
    metrics of every step and, from the mesh's first rank, the gathered
    params after the last step (None on ranks outside the mesh)."""
    from streamvln_tpu_torch.parallel import dpo
    from streamvln_tpu_torch.parallel import mesh as mesh_lib
    from streamvln_tpu_torch.parallel import train as train_lib
    from streamvln_tpu_torch.weights import from_jax_params
    results = []
    for case in cases:
        mesh = mesh_lib.make_mesh(*case["mesh"])
        if mesh.get_coordinate() is None:
            results.append(None)
            continue
        cfg, tcfg = case["cfg"], case["tcfg"]
        params = mesh_lib.shard_params(
            from_jax_params(case["params"], cfg, device="cpu"), mesh)
        state = train_lib.create_train_state(params, tcfg)
        if "dpo" in case:
            ref_np, beta = case["dpo"]
            ref = mesh_lib.shard_params(
                from_jax_params(ref_np, cfg, device="cpu"), mesh)
            step = dpo.make_dpo_step(cfg, tcfg, "cpu", beta, mesh=mesh)
            run_step = lambda s, b: step(s, ref, b)    # noqa: E731
        else:
            run_step = train_lib.make_train_step(cfg, tcfg, "cpu", mesh)
        metrics = []
        for b in case["batches"]:
            state, m = run_step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        flat = _full_flat(state.params)
        results.append({"metrics": metrics,
                        "params": flat if rank == 0 else None,
                        "dtensor": all(mesh_lib.is_dtensor(t) for t in
                                       _leaves(state.params))})
        del state
    return results


def _leaves(params):
    from streamvln_tpu_torch.parallel.train import tree_leaves
    return [t for _, t in tree_leaves(params)]


def cli_rank(rank, world, runs):
    """The training command in this rank of the group (torchrun's
    variables set by `_worker`), once per argv of `runs`; returns each
    run's standard output on this rank."""
    import contextlib
    import io
    from streamvln_tpu_torch import train as train_cli
    seen = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_cli.main(argv)
        seen.append(buf.getvalue())
    return seen
