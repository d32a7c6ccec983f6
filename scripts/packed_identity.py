#!/usr/bin/env python3
"""Where does a packed mixed step part from whole-prompt prefill and the
decode step, op by op?

    python3 scripts/packed_identity.py [--float] [--layers N]
        [--prompt-len 120] [--prompt-pad N] [--chunk 32] [--budget 64]
        [--decode-steps 4]
        [--device cuda] [--out FILE]

At smollm-135m's full width (random weights, seed 0; rns9 MLP unless
``--float``), one prompt of the [serve] traffic goes through the port
twice: whole, through ``prefill_ragged`` padded to ``--prompt-pad``
(default: the row's capacity, the engine's default),
and in chunks of ``--chunk`` tokens through ``mixed_step`` over
``--budget`` lanes (the rest pad lanes), as the chunked engine runs it.
Every float op of every layer is recorded on both paths (the norms, q/k/v
after rope, the attention output, the wo projection, the MLP, the
residual stream), and for each the prompt's rows are compared: bit-equal
or the largest difference.  Then, from ONE copy of the whole path's KV
pages, ``--decode-steps`` decode steps run both ways: ``decode_step``
over ``max_seqs`` rows against ``mixed_step`` with one decode lane, op
by op again.  It prints the first op that differs on each comparison and
the first-token logits' gap, and writes everything, as JSON, to
``--out`` when given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import at_depth, get_config  # noqa: E402
from repro_torch.core.rns_matmul import RnsDotConfig  # noqa: E402
from repro_torch.launch.serve import request_prompts  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import kv_cache as kv  # noqa: E402


class Recorder:
    """Records every float op's output of every layer, in call order, as
    (layer, op, [rows, -1] tensor); ``rows`` is the number of token rows
    of the run being recorded."""

    def __init__(self):
        self.on = False
        self.rows = 0
        self.layer = -1
        self.seen = collections.Counter()
        self.log: list = []
        self._saved = []

    def put(self, op, t):
        if self.on:
            self.seen[(self.layer, op)] += 1
            name = f"{op}#{self.seen[(self.layer, op)] - 1}"
            self.log.append((self.layer, name, t.detach().reshape(
                self.rows, -1).float().clone()))

    def _wrap(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        rec = self

        def apply_layer(orig):
            def f(blk, h, cfg, *, slot, **kw):
                rec.layer = slot        # the layer (one layer type here)
                h, kv_, aux = orig(blk, h, cfg, slot=slot, **kw)
                rec.put("h", h)
                return h, kv_, aux
            return f

        def outputs(op):
            def make(orig):
                def f(*a, **k):
                    out = orig(*a, **k)
                    for i, t in enumerate(out if isinstance(out, tuple)
                                          else (out,)):
                        rec.put(f"{op}{i}" if isinstance(out, tuple) else op,
                                t)
                    return out
                return f
            return make

        def logits(orig):
            def f(*a, **k):         # the head: compared as logits instead
                on, rec.on = rec.on, False
                try:
                    return orig(*a, **k)
                finally:
                    rec.on = on
            return f

        self._wrap(tf, "_apply_layer", apply_layer)
        self._wrap(M, "_logits", logits)
        self._wrap(tf, "mlp", outputs("mlp"))
        self._wrap(layers.RMSNorm, "forward", outputs("norm"))
        self._wrap(attn, "gqa_qkv", outputs("qkv"))
        self._wrap(attn, "lane_attention", outputs("attend"))
        self._wrap(attn, "linear", outputs("wo"))

    def run(self, rows, fn):
        self.log, self.rows, self.on = [], rows, True
        self.seen.clear()
        try:
            out = fn()
        finally:
            self.on = False
        return out, self.log


def compare(a_log, a_rows, b_log, b_rows):
    """Per (layer, op): the two paths' rows (index lists) compared."""
    b_by = {(layer, op): t for layer, op, t in b_log}
    out = []
    for layer, op, t in a_log:
        u = b_by.get((layer, op))
        if u is None:
            continue
        x, y = t[a_rows], u[b_rows]
        diff = (x - y).abs()
        out.append({"layer": layer, "op": op,
                    "equal": bool(torch.equal(x, y)),
                    "max_abs_diff": float(diff.max()),
                    "rows_differing": int((diff.amax(dim=1) > 0).sum()),
                    "rows": len(a_rows)})
    return out


def first_diff(rows):
    return next((r for r in rows if not r["equal"]), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--float", action="store_true",
                    help="float MLP (no RNS datapath)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=120)
    ap.add_argument("--prompt-pad", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("smollm-135m")
    if not args.float:
        cfg = dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                        qw=8),
                                  rns_targets="mlp")
    if args.layers:
        cfg = at_depth(cfg, args.layers)
    model = M.init_model(cfg, seed=0, device=dev)
    prompt = next(p for p in request_prompts(cfg.vocab, 6, (7, 33, 120))
                  if len(p) == args.prompt_len)
    T = len(prompt)
    bs, R, new = 16, 8, 16
    nb = -(-(T + new + 8) // bs)
    Tpad = args.prompt_pad or nb * bs  # the engine's default prompt_pad
    rec = Recorder()
    rec.install()

    # whole prompt: prefill_ragged, the engine's phase-barrier program
    toks = torch.zeros((1, Tpad), dtype=torch.int64, device=dev)
    toks[0, :T] = torch.as_tensor(prompt, device=dev)
    (logits_w, ys), whole = rec.run(Tpad, lambda: M.prefill_ragged(
        model, cfg, toks, torch.tensor([T], device=dev)))

    # the same prompt in chunks through the packed step
    pcfg = kv.PagedCacheConfig(page_size=bs, n_pages=1 + R * nb, max_seqs=R,
                               max_blocks=nb)
    cache = kv.make_paged_cache(cfg, pcfg, device=dev)
    bt = torch.zeros((R, nb), dtype=torch.int64)
    bt[0] = torch.arange(1, nb + 1)
    lengths = torch.zeros((R,), dtype=torch.int64)
    lengths[0] = T
    kv.set_tables(cache, bt, lengths)
    N = args.budget
    packed, logits_p = [], None
    for c0 in range(0, T, args.chunk):
        n = min(args.chunk, T - c0)
        lane = {k: torch.zeros((N,), dtype=torch.int64, device=dev)
                for k in ("tokens", "seg", "pos")}
        lane["seg"].fill_(-1)
        lane["tokens"][:n] = torch.as_tensor(prompt[c0:c0 + n], device=dev)
        lane["seg"][:n] = 0
        lane["pos"][:n] = torch.arange(c0, c0 + n, device=dev)
        valid = lane["seg"] >= 0
        lg, log = rec.run(N, lambda: M.mixed_step(
            model, cfg, lane["tokens"], lane["seg"], lane["pos"],
            torch.zeros((N,), dtype=torch.bool, device=dev), valid, cache))
        packed.append((n, log))
        logits_p = lg[n - 1]
    # stitch the chunks' rows into the prompt's order
    stitched = []
    for (layer, op, _t) in packed[0][1]:
        parts = [dict(((l_, o_), t_) for l_, o_, t_ in log)[(layer, op)][:n]
                 for n, log in packed]
        stitched.append((layer, op, torch.cat(parts)))
    prefill_rows = compare(whole, list(range(T)), stitched, list(range(T)))
    lw, lp = logits_w[0].float(), logits_p.float()
    top2 = torch.topk(lw, 2).values
    report = {
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "config": {"layers": cfg.n_layers, "d_model": cfg.d_model,
                   "rns": None if cfg.rns is None else cfg.rns.profile,
                   "prompt_len": T, "prompt_pad": Tpad, "chunk": args.chunk,
                   "budget": N},
        "prefill": {"first_diff": first_diff(prefill_rows),
                    "ops": prefill_rows,
                    "first_token_whole": int(lw.argmax()),
                    "first_token_packed": int(lp.argmax()),
                    "logits_max_abs_diff": float((lw - lp).abs().max()),
                    "whole_top2_gap": float(top2[0] - top2[1])}}

    # decode: decode_step over R rows vs mixed_step with one decode lane,
    # each from its own copy of the whole path's pages
    dcache = kv.make_paged_cache(cfg, pcfg, device=dev)
    row = bt[0].to(dev)[: Tpad // bs]
    kv.write_prompt_pages(dcache.k_pages, row,
                          torch.stack([k[0] for k, _ in ys]))
    kv.write_prompt_pages(dcache.v_pages, row,
                          torch.stack([v[0] for _, v in ys]))
    kv.set_tables(dcache, bt, lengths)
    mcache = kv.PagedKV(dcache.k_pages.clone(), dcache.v_pages.clone(),
                        dcache.block_table.clone(), dcache.lengths.clone())
    tok = int(lw.argmax())
    steps = []
    active = torch.zeros((R,), dtype=torch.bool, device=dev)
    active[0] = True
    for s in range(args.decode_steps):
        token = torch.zeros((R, 1), dtype=torch.int64, device=dev)
        token[0, 0] = tok
        ld, dlog = rec.run(R, lambda: M.decode_step(model, cfg, token, dcache,
                                                    active))
        lane = torch.zeros((N,), dtype=torch.int64, device=dev)
        seg = torch.full((N,), -1, dtype=torch.int64, device=dev)
        pos = torch.zeros((N,), dtype=torch.int64, device=dev)
        lane[0], seg[0], pos[0] = tok, 0, T + s
        dec = seg >= 0
        lm, mlog = rec.run(N, lambda: M.mixed_step(model, cfg, lane, seg, pos,
                                                   dec, dec, mcache))
        rows = compare(dlog, [0], mlog, [0])
        steps.append({"step": s, "first_diff": first_diff(rows),
                      "n_ops_differing": sum(not r["equal"] for r in rows),
                      "token_decode": int(ld[0].argmax()),
                      "token_mixed": int(lm[0].argmax()),
                      "logits_max_abs_diff": float(
                          (ld[0] - lm[0]).abs().max())})
        tok = int(ld[0].argmax())
    report["decode"] = steps
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "prefill"}))
    pf = report["prefill"]
    print("prefill first differing op:", json.dumps(pf["first_diff"]))
    print("prefill first token whole / packed:", pf["first_token_whole"],
          pf["first_token_packed"], "logit gap", pf["logits_max_abs_diff"],
          "whole top-2 gap", pf["whole_top2_gap"])
    for r in prefill_rows[:40]:
        print("  ", json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
