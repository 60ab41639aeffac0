"""Launch plans of the kernels on attn_kv.cuh's layout, kernels 3 and 4
(the kv+e attention forward and backward) and kernels 1 and 2 (the
external-logits softmax-aggregate), each one knob away from the
wrappers' own (`attention_plan`, `aggregate_plan`), timed on the card at
`chip_smoke.py`'s flagship cases:

    python gnnep_tpu_torch/dev/attn_variants.py [--out FILE] [--pairs attn,agg]

Run from the root of a checkout. For the line-graph and the atom conv, f32
and bf16, each plan goes through the package's wrappers (`plan=`): the
plans' own, the evict-first loads (and kernel 2's streaming stores)
flipped in both plans, 1, 2 or 4 heads to a warp (one warp a row), 1, 2
or 4 warps a row (the plan's heads a warp), 2, 4 or 8 warps a block, and
the backward's dummy-row zeroing on 1 or 132 blocks. Each plan's outputs are held against the own plan's at
chip_smoke's tolerances (1e-4 f32, 1e-2 bf16 of the largest magnitude);
device ms per launch is chip_smoke's `device_ms` (the median of 30 chains
of 10).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

# (name, knob, value): "own" is the plans as the wrappers make them; "hs" a
# (heads a warp, warps a row) pair forced through the planner; the others
# replace one field of both own plans
LAYOUTS = (("own", None, None), ("stream", "stream", None),
           ("hpw1", "hs", (1, 1)), ("hpw2", "hs", (2, 1)),
           ("hpw4", "hs", (4, 1)), ("split1", "hs", (None, 1)),
           ("split2", "hs", (None, 2)), ("split4", "hs", (None, 4)),
           ("warps2", "warps", 2), ("warps4", "warps", 4),
           ("warps8", "warps", 8), ("tail1", "tail_blocks", 1),
           ("tail132", "tail_blocks", 132))


def pair_fns(cs, pair, c):
    """The pair's (forced plan of case `c`, own plan of `c`, forward,
    backward, bounds): kernels 3 and 4 ("attn") or 1 and 2 ("agg")."""
    if pair == "attn":
        from gnnep_tpu_torch.ops.cuda import attention as at
        q, k, v = c["q"], c["k"], c["v"]

        def own(backward):
            return at.attention_plan(q.shape[0], k.shape[0], q.shape[1],
                                     c["heads"], q.element_size(),
                                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     backward=backward)

        def fwd(plan):
            return at.attention_cuda(*cs.attn_fwd_args(c), c["row_ptr"],
                                     heads=c["heads"], plan=plan)

        def bwd(plan, g, f):
            return at.attention_bwd_cuda(*cs.attn_fwd_args(c), c["row_ptr"],
                                         g, f[1], f[2], heads=c["heads"],
                                         plan=plan)

        return (cs.attn_plan, own, fwd, bwd,
                (cs.attn_bound_ms(c)[0], cs.attn_bwd_bound_ms(c)[0]))
    from gnnep_tpu_torch.ops.cuda import aggregate as ag
    v = c["v"]

    def own(backward):
        return ag.aggregate_plan(c["n"], v.shape[0], v.shape[1], c["heads"],
                                 v.element_size(), v.data_ptr(),
                                 backward=backward)

    def fwd(plan):
        return ag.aggregate_cuda(*cs.agg_fwd_args(c), heads=c["heads"],
                                 plan=plan)

    def bwd(plan, g, f):
        return ag.aggregate_bwd_cuda(*cs.agg_fwd_args(c), g, f[1], f[2],
                                     heads=c["heads"], plan=plan)

    return (cs.agg_plan, own, fwd, bwd,
            (cs.agg_bound_ms(c)[0], cs.agg_bwd_bound_ms(c)[0]))


def plans(forced, own, c, knob, value):
    """(the forward's plan, the backward's) of case `c` with one knob set."""
    if knob == "hs":
        c2 = dict(c, hpw=value[0], split=value[1])
        return forced(c2), forced(c2, backward=True)
    mine = [own(b) for b in (False, True)]
    if knob is None:
        return mine
    if knob == "stream":
        return [dataclasses.replace(p, stream=not p.stream) for p in mine]
    if knob == "warps" and any(value % p.split for p in mine):
        raise ValueError(f"{value} warps hold no whole rows of "
                         f"{mine[0].split} or {mine[1].split} warps")
    return [dataclasses.replace(p, **{knob: value}) for p in mine]


def main(argv=None) -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--pairs", default="attn,agg",
                        help="kernels 3 and 4 (attn), 1 and 2 (agg)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import chip_smoke as cs
    dev, smi = cs.phase_device()
    tmp = tempfile.mkdtemp(prefix="attn_variants_")
    data, _, _ = cs.write_fixture(Path(tmp) / "fixture")
    _, batches = cs.training_setup(data, Path(tmp) / "fixture")
    rng = np.random.default_rng(cs.SEED + 50)
    rows = []
    for pair in args.pairs.split(","):
        for which in ("lg", "atom"):
            for dtype in (torch.float32, torch.bfloat16):
                tag = "float32" if dtype == torch.float32 else "bfloat16"
                case = cs.batch_case(rng, batches[0], which, hidden=256,
                                     dtype=dtype, device=dev)
                c = (cs.attn_inputs(case) if pair == "attn"
                     else cs.agg_inputs(rng, case))
                forced, own, fwd, bwd, bounds = pair_fns(cs, pair, c)
                tol = 1e-4 if tag == "float32" else 1e-2
                gen = torch.Generator(device=dev).manual_seed(0)
                n = c["row_ptr"].shape[0] - 1
                g = torch.randn((n, c["v"].shape[1]), generator=gen,
                                device=dev)
                want = None
                for name, knob, value in LAYOUTS:
                    try:
                        plan, bplan = plans(forced, own, c, knob, value)
                    except ValueError as e:  # no such plan at this shape
                        print(f"[variant] {pair} {name} {which} {tag}: {e}",
                              flush=True)
                        continue
                    f = fwd(plan)
                    b = bwd(bplan, g, f)
                    got = [x.float()[:-1] for x in f] + [x.float() for x in b]
                    want = want or got
                    err = max(((x - y).abs().max() / y.abs().max().clamp_min(
                        1e-30)).item() for x, y in zip(got, want))
                    if not err <= tol:
                        raise AssertionError(f"{pair} {name} {which} {tag}: "
                                             f"differs from the own plan by "
                                             f"{err:.3e}")
                    r = {"pair": pair, "layout": name, "conv": which,
                         "dtype": tag,
                         "plans": [dataclasses.asdict(x)
                                   for x in (plan, bplan)],
                         "fwd_ms": cs.device_ms(lambda: fwd(plan)),
                         "bwd_ms": cs.device_ms(lambda: bwd(bplan, g, f)),
                         "fwd_bound_ms": bounds[0], "bwd_bound_ms": bounds[1],
                         "rel_err_vs_own": err}
                    print(f"[variant] {json.dumps(r)}", flush=True)
                    rows.append(r)
    shutil.rmtree(tmp)
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
