"""How far `chip_smoke.py`'s layout limits lie from sound runs and from
planted faults: the graph-aligned step over the two-rank gloo pair on one
card against the union-batch step (`[mesh]`), and the S = 2 boundary
forward and step of the giants against the unpartitioned graph
(`[giant]`), f32 and bf16, each comparison's error and limit read from
`chip_smoke.layout_limits` / `near_limit` without stopping at a limit:

    python /path/to/gnnep_tpu_torch/dev/limit_probe.py TAG [--plant FAULT]
        [--giant-only]

It runs `chip_smoke.py`'s `phase_mesh` and `phase_giant` (after
`phase_featurize`, which writes the giants' crystal) of the checkout in
the current directory; `--giant-only` leaves out `phase_mesh`. `--plant FAULT` copies that checkout into a
temporary directory, plants one fault there by replacing a line of the
copy, and runs the copy instead; the checkout itself is not touched:
- `drop_rank1`: rank 1's gradient and metric sums are left out of the
  step's sum all-reduce (one rank's sub-batch dropped);
- `edge_sum`: the boundary step sums its gradients over the edge axis
  instead of averaging them (the missing ÷E);
- `no_pool_psum`: the boundary trunk pools each rank's rows alone (the
  pooling partials are not summed over the edge axis); the f32 forward
  check then fails first, so the f32 forward comparison is let through to
  reach the bf16 readings;
- `bf16_pool`: the boundary trunk pools in the compute type (bf16) instead
  of f32; f32 runs are unchanged.
Where a bf16 comparison holds the result to the reference layout's bf16
result itself (`direct`, `[giant]`), a second row, "(L2 rule)", reads the
same result by the rule of the other bf16 comparisons (as near the f32
result as the reference, NOISE_FACTOR times, plus a floor).
Prints one line, `LIMITS {json}`: every comparison's (what, dtype, item,
err, limit) and the phases' other failures, with TAG and the card's name
and power limit.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

FAULTS = {
    "drop_rank1": ("gnnep_tpu_torch/parallel/train_step.py",
                   "        all_reduce_sum(rank, self.buf)\n",
                   "        if rank.rank == 1:\n"
                   "            self.buf.zero_()\n"
                   "        all_reduce_sum(rank, self.buf)\n"),
    "edge_sum": ("gnnep_tpu_torch/parallel/train_step.py",
                 "            self.flat.n_global() * "
                 "self.rank.axis_size(EDGE_AXIS))\n",
                 "            self.flat.n_global())\n"),
    "no_pool_psum": ("gnnep_tpu_torch/parallel/boundary_shard.py",
                     "    stacked = psum(rank, torch.cat([sums, "
                     "counts[:, None]], dim=-1),\n                   "
                     "EDGE_AXIS)\n",
                     "    stacked = torch.cat([sums, counts[:, None]], "
                     "dim=-1)\n"),
    "bf16_pool": ("gnnep_tpu_torch/parallel/boundary_shard.py",
                  "    state = node_state.float()\n",
                  "    state = node_state\n"),
}


def planted(tag: str, fault: str) -> int:
    """Run this probe in a copy of the current checkout with `fault`."""
    rel, old, new = FAULTS[fault]
    with tempfile.TemporaryDirectory(prefix="limit_probe_") as tmp:
        copy = Path(tmp) / "tree"
        shutil.copytree(Path.cwd(), copy, symlinks=True,
                        ignore=shutil.ignore_patterns(".git", "_tree",
                                                      "chiprun_out"))
        path = copy / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{fault}: its line is not in {rel} once")
        path.write_text(text.replace(old, new))
        script = copy / Path(__file__).resolve().relative_to(
            Path.cwd().resolve())
        flags = ["--lenient"] if fault == "no_pool_psum" else []
        flags += ["--giant-only"] if "--giant-only" in sys.argv else []
        return subprocess.call([sys.executable, str(script), tag, *flags],
                               cwd=copy)


def main(tag: str, lenient: bool, giant_only: bool) -> None:
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from gnnep_tpu_torch.ops.cuda import build
    from gnnep_tpu_torch.parallel.mesh import World
    dev, smi = cs.phase_device()
    build.build(["attn_eproj_fwd", "attn_eproj_bwd", "csr_segment_sum"])
    rows, errors = [], []

    def compare(what, dtype, metrics, ref_metrics, grads, ref_grads,
                f32=None, direct=False):
        for item, err, lim in cs.layout_limits(dtype, metrics, ref_metrics,
                                               grads, ref_grads, f32,
                                               direct):
            rows.append(dict(what=what, dtype=dtype, item=item,
                             err=float(err), limit=float(lim)))
        if direct and f32 is not None:
            names = sorted(grads)
            err, lim = cs.near_limit(*(
                np.concatenate([d[n].ravel() for n in names])
                for d in (grads, ref_grads, f32[1])), 1e-3)
            rows.append(dict(what=what, dtype=dtype,
                             item="all leaves (L2 rule)", err=float(err),
                             limit=float(lim)))
        return dict(metrics_share_of_limit="-", grad_share_of_limit="-",
                    nearest_leaf="-")

    def near(what, got, ref, f32, floor, direct=False):
        err, lim = cs.near_limit(got, ref, f32, floor, direct)
        rows.append(dict(what=what, dtype="bfloat16", item="forward",
                         err=float(err), limit=float(lim)))
        if direct:
            e2, l2 = cs.near_limit(got, ref, f32, 1e-2)
            rows.append(dict(what=what, dtype="bfloat16",
                             item="forward (L2 rule)", err=float(e2),
                             limit=float(l2)))
        return err / lim

    cs.compare_layouts, cs.near_as_ref = compare, near
    if lenient:
        np.allclose = lambda *a, **k: True
    with tempfile.TemporaryDirectory(prefix="limit_probe_") as tmp:
        root = Path(tmp)
        data, ens, cfg = cs.write_fixture(root)
        setup, train_batches = cs.training_setup(data, root)
        cs.phase_featurize(root, ens, cfg.layers)
        phases = [] if giant_only else [
            ("mesh", lambda: cs.phase_mesh(pair, root, data, setup,
                                           train_batches, dev, cfg.layers))]
        phases.append(("giant", lambda: cs.phase_giant(pair, root, data, dev,
                                                       cfg.layers)))
        with World(cs.pair_mesh(dev)) as pair:
            for name, run in phases:
                try:
                    run()
                except Exception as exc:  # noqa: BLE001 - read, then go on
                    errors.append(f"{name}: {exc!r}"[:400])
    print("LIMITS " + json.dumps(dict(tag=tag, card=smi, rows=rows,
                                      errors=errors), default=float),
          flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--plant" in args:
        i = args.index("--plant")
        raise SystemExit(planted(args[0], args[i + 1]))
    main(args[0] if args else "tree", "--lenient" in args,
         "--giant-only" in args)
