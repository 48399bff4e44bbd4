"""The multi-process leg of the sharded engine: one rank of a
torch.distributed group serving a saved sharded IVF-Flat index.

:func:`run_group` starts ``world`` processes of this module (``python -m
raft_tpu_torch.testing.dist``, :func:`main`), one per rank, that join a
process group through a ``file://`` init method
(:meth:`~raft_tpu_torch.comms.Comms.initialize_distributed`: gloo on the
CPU, NCCL on a card), run the communicator self-tests, load the archive
onto their rank (``load_index(path, comms=)``, which re-partitions an
index saved at another rank count), and search the saved queries —
healthy, and degraded with ``down`` ranks marked down. They also run the
hierarchical allreduce of a two-level ``DistComms`` (the ranks as
one-rank hosts) against the flat one. Each rank writes its answers to
``<out>.<rank>.npz``, with whether any module of JAX was imported (the
port never imports it). Every process has its own timeout, and
:func:`run_group` kills whatever outlives it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional

__all__ = ["main", "run_group"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", required=True, help="file:// rendezvous path")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--archive", required=True)
    ap.add_argument("--queries", required=True, help=".npy (nq, d) f32")
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--n-probes", type=int, default=8)
    ap.add_argument("--qcap", type=int, default=None)
    ap.add_argument("--down", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from raft_tpu_torch.comms import (
        Comms,
        DistComms,
        mnmg_ivf_flat_search,
        run_all_self_tests,
    )
    from raft_tpu_torch.spatial.ann import load_index

    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", args.rank % torch.cuda.device_count())
    comms = Comms.initialize_distributed(
        args.init, args.world, args.rank, device=dev,
        timeout_s=args.timeout)
    try:
        tests = run_all_self_tests(comms)
        # the two-level form: the ranks as (world, 1) hosts — the
        # hierarchical allreduce must equal the flat one
        hier = DistComms(device=dev, mesh_shape=(args.world, 1))
        x = torch.arange(12, dtype=torch.float32, device=dev).reshape(
            4, 3) * (args.rank + 1)
        hier_ok = hier.run(lambda ax, v: bool(torch.equal(
            hier.hierarchical_allreduce(ax, v), ax.allreduce(v))),
            replicated=(x,))
        index = load_index(args.archive, comms=comms)
        q = torch.as_tensor(np.load(args.queries), device=dev)
        d, ids = mnmg_ivf_flat_search(comms, index, q, args.k,
                                      n_probes=args.n_probes,
                                      qcap=args.qcap)
        mask = np.ones(args.world, np.int32)
        mask[list(args.down)] = 0
        part = mnmg_ivf_flat_search(comms, index, q, args.k,
                                    n_probes=args.n_probes, qcap=args.qcap,
                                    shard_mask=mask)
        np.savez(
            f"{args.out}.{args.rank}.npz",
            dists=d.cpu().numpy(), ids=ids.cpu().numpy(),
            part_dists=part.distances.cpu().numpy(),
            part_ids=part.ids.cpu().numpy(),
            coverage=part.coverage.cpu().numpy(),
            self_tests=np.array([tests[n] for n in sorted(tests)]),
            self_test_names=np.array(sorted(tests)),
            hier_allreduce_ok=np.array(hier_ok),
            jax_loaded=np.array(any(m == "jax" or m.startswith("jax.")
                                    for m in sys.modules)),
        )
    finally:
        dist.destroy_process_group()
    return 0


def run_group(world: int, *, init: str, archive: str, queries: str,
              out: str, k: int = 10, n_probes: int = 8,
              qcap: Optional[int] = None, down: List[int] = (),
              device: str = "cpu", timeout_s: float = 60.0) -> List[dict]:
    """Run ``world`` ranks of :func:`main` to their end (each within
    ``timeout_s``, killed otherwise) and return each rank's answers."""
    import numpy as np

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "raft_tpu_torch.testing.dist",
               "--init", init, "--rank", str(rank), "--world", str(world),
               "--archive", archive, "--queries", queries, "--out", out,
               "--k", str(k), "--n-probes", str(n_probes),
               "--device", device, "--timeout", str(timeout_s)]
        if qcap is not None:
            cmd += ["--qcap", str(qcap)]
        if down:
            cmd += ["--down", *map(str, down)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    failures = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout_s + 30.0)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise TimeoutError(f"rank {rank} did not finish within "
                               f"{timeout_s + 30.0:.0f} s")
        if p.returncode != 0:
            failures.append(f"rank {rank} exited {p.returncode}:\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))
    results = []
    for rank in range(world):
        with np.load(f"{out}.{rank}.npz") as z:
            results.append({key: z[key] for key in z.files})
    return results


if __name__ == "__main__":
    sys.exit(main())
