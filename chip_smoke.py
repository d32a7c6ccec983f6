#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit.  Phases (any failure makes the exit code non-zero):

  [build]       compile every CUDA source of the checkout (one nvcc
                each, all in parallel; every compiled tile is a template
                instantiation), print each build's time and
                ``ptxas -v``, and hold each instantiation's registers to
                the tile checker's register model; count the tensor-core
                instructions in the SASS (``cuobjdump -sass``): IMMA in
                rns_matmul and rns_fused_mma (the fused dot, matmul +
                normalize and, counted on its own too, encode + matmul),
                HMMA in flash_attention, none may be 0; and MUFU.RCP
                (a division's reciprocal) in rns_normalize, which must
                be 0;
  [serve]       full-width smollm-135m with the rns9 MLP datapath through
                ContinuousEngine.run on mixed-length requests (after one
                short warm-up request): the per-op path, weights
                re-encoded every step, three kernels.  Each path is
                served twice.  First eager (``graphs=False``): every
                kernel's launch count is set to 0 just before and read
                after, a copy is kept of each distinct call the wrappers
                see, and each decode step's launches are held to the
                path's; then captured (the engine's prefill and decode
                replayed from CUDA graphs): the same greedy tokens and
                rns_ops as the eager serve, each phase captured once,
                and torch.profiler's count of the kernels in one
                replayed decode step equal to the eager launches.  The
                captured serve is re-served under torch.profiler for the
                device's idle share, and the two are printed side by
                side;
  [serve_fused] the same on the fused path: resident weights (encoded
                once at engine build), the deferred MLP and the fused
                kernels (``rns_backend="cuda_fused"``), with the
                launches of every decode step held to 30 each of the
                three fused kernels and rns_convert, and none of
                rns_matmul or rns_normalize;
  [serve_per_layer] the same on the fused path with per-layer profiles
                (``per_layer_profiles=True``): every layer on the
                profile its weights select (rns7 for these weights), 120
                launches a decode step, tokens equal to [serve_fused]'s;
  [serve_chunked] the [serve] traffic with chunked prefill (every step
                one packed mixed step over 64 lanes, prefill chunks of at
                most 32 tokens) on the per-op path and on the fused path,
                eager (counts from 0, every distinct wrapper call
                recorded: the packed shapes [tune] and [kernels] take up;
                each step's launches the path's decode step's) then
                captured (one mixed program captured once across every
                phase mix, the eager serve's tokens and rns_ops); greedy
                tokens equal to [serve]'s and [serve_fused]'s; one
                replayed mixed step, and one replayed decode step of
                each untuned serve, listed by kernel name, top 20 by
                device time (torch.profiler);
  [serve_prefix] a chat service's traffic -- a 96-token system prompt, a
                user turn of 7-40 tokens a request, the first request
                sent again -- on the per-op path, captured: without the
                prefix cache, with it (prompt_pad 144) and with it
                chunked; tokens equal to the uncached serve's, pages
                shared, cached tokens served, the regenerate's partial
                tail split copy-on-write (the copy captured once);
  [serve_spec]  speculative decoding (3 drafts from 3-gram prompt
                lookup) of the [serve] traffic plus a request whose
                prompt is a 16-token phrase said four times: per-op and
                fused phase-barrier (one verify program: decode_window,
                argmax, greedy accept on the device) and per-op chunked
                (spec windows in the mixed step's lanes), eager (counts
                from 0, every distinct call recorded: the [8,4,.] verify
                rows go to [tune] and [kernels]; each verify step's
                launches its path's decode step's) then captured
                (``verify=1 prefill=1`` or ``mixed=1``); greedy tokens
                equal to the same prompts served plainly on the same
                path; tokens a step and acceptance rate;
  [serve_window] the [serve] prompts with 96 new tokens, a 64-token
                sliding window and a pool of 49 pages (113 unwindowed),
                per-op, phase-barrier and chunked, eager then captured:
                pages recycled by the window, greedy tokens equal to the
                windowed bucketed Engine's captured solo runs;
  [serve_bucketed] the bucketed Engine on 8 prompts of 33 tokens, per-op
                and fused resident, eager (recorded: the dense [8,33,.]
                and [8,1,.] shapes) then captured (``prefill(8,33)=1
                decode(8)=1``): the same tokens, every decode step
                launching its path's decode kernels, and greedy tokens
                equal to the ContinuousEngine's on the same prompts;
  [tune]        with the block table pointed at a fresh file under
                build/, tune every kernel kind at every shape bucket the
                serves gave the wrappers (on the recorded inputs),
                and flash_attention at smollm-135m's attention geometry
                (Tq = Tk = 120 and 2048, causal): every legal candidate
                is held against the plain version and timed, and every
                candidate the checker drops is printed with its reason;
  [serve_tuned] the three serves again, eager and captured, with engines
                built after the tuned table is in force (a captured step
                keeps the tiles it was captured with; each also
                re-served under torch.profiler): greedy tokens bit-equal
                to the untuned serves, the same launches per decode
                step, every launch on its bucket's row, and its numbers
                beside the untuned run's;
  [serve_mla]   DeepSeek-V2 (MLA attention, 160-expert MoE with 2 shared
                experts, untied head) at its published width, depth 2,
                capacity 27 (dropless), rns9 on the shared experts: a
                120-token prefill's logits on the kernels bit-equal to the
                plain RNS path on the card (``rns_targets="all"``); the
                [serve] traffic per-op, with ``rns_targets="all"`` (the MLA
                projections too), chunked, speculative and fused, eager
                (counts from 0, every distinct call recorded for
                [kernels], each decode / verify / mixed step's launches
                the path's) then captured (one capture a program, the
                eager tokens and rns_ops, a replayed step's kernels);
                chunked and speculative tokens equal to the whole-prompt
                serve's; the bucketed Engine on 8 x 33, eager and
                captured, its tokens the ContinuousEngine's; the peak
                device memory;
  [kernels]     hold all seven kernels against their plain PyTorch
                versions on the card -- the six RNS kernels bit for bit
                on the inputs the serves gave them (every distinct
                shape), at every candidate tiling on one main-path input
                each, and on boundary cases of every profile (rns8_u8's
                int32 residues included; rns_normalize on the edge
                values 0, 1, M/2 - 1, M/2, M/2 + 1, M - 1, T % 4 != 0
                (planes off a 16-byte boundary) and a view one int32
                off one; rns_matmul, the fused dot and
                the fused matmul + normalize (int8 and int32 a) at every
                candidate tile with their K steps split among blocks;
                the fused encode + matmul also on both main-path inputs
                at every compiled tile with its split forced 1, 2 and 4
                ways);
                flash_attention within 2e-5 (float32; plus one step of
                the type in bfloat16) on ragged and full-width shapes,
                at every candidate tile --
                and time kernel, plain
                version and the library yardstick (torch._int_mm,
                scaled_dot_product_attention), and, beside each fused
                kernel's main-path input, the port's unfused chain on
                the same inputs (rns_convert -> rns_matmul ->
                rns_normalize, or its first or last two) in one graph;
  [identity]    the same seeded weights and prompts at a reduced depth:
                per-op path on the card (kernels) vs the CPU (plain path)
                -- one RNS projection bit-equal, first-step logits within
                LOGIT_TOL, every greedy token equal; on the card, the
                fused resident per-op path vs the re-encode per-op path
                -- logits and tokens bit-equal; the deferred fused path on
                the card vs the CPU -- logits within LOGIT_TOL, every
                greedy token equal; and the same with per-layer profiles
                -- the same profiles selected on both devices.  The card's
                engines here are captured;
  [fractional]  Olsen fractional RNS (core/fractional.py) and fractional
                residue tensors (frac_exp != 0).  With every launch count
                set to 0: rns9 fractional weights at smollm-135m's MLP
                widths through rt_dot (B.4), rt_matmul_decode (B.6) and
                rt_decode of rt_matmul (B.2, B.3) on the decode and
                prefill rows, each of B.3, B.4 and B.6 launched at least
                once with M_f**-frac_exp in its weight table, the floats
                bit-equal to the same calls on the CPU; then the
                Mandelbrot demo (launch/mandelbrot.py) at 1920 x 1080, 256
                iterations on rns12, captured and eager (equal escape
                counts, one capture, pixel-iterations per second,
                agreement with float64); a 256 x 256 crop of that view
                captured, eager and on the CPU (equal escape counts, and
                equal to the full render's window); the rns24_deep proof
                (two c values one float64 apart, orbits that differ, as
                on the CPU); and B.3, B.4 and B.6 with a scaled table
                (rns9 at M_f**-1, M_f**-2 and M_f**-10, the last outside
                float32) bit for bit against their plain versions at the
                main path's decode and prefill inputs, one timed row of
                each beside the same inputs unscaled.

  [serve_archs] tinyllama-1.1b at full width, depth 11, granite-3-8b at
                full width, depth 10,
                qwen2.5-32b (q/k/v bias) at full width, depth 4, and
                Llama-4-Scout at full width, depth 2, capacity 16
                (dropless), rns9, random weights from seed 0: the
                [serve] traffic through ContinuousEngine (tinyllama,
                granite; qwen per-op, ``rns_targets="all"``, chunked and
                fused resident; Scout per-op and fused) and the bucketed
                Engine on 8 x 33 (granite, qwen, Scout: the [8,33,.]
                prefill rows at their widths), each eager (counts from 0,
                every distinct wrapper call recorded and held bit for
                bit to its plain version and timed while the model is on
                the card, each decode / mixed step's launches equal and
                agreeing with its rns_ops) then captured (one capture a
                program, the eager tokens and rns_ops, the replayed
                step's kernel nodes the eager step's launches); qwen's
                chunked tokens equal its whole-prompt ones, Scout's
                bucketed tokens its ContinuousEngine's; each model's
                peak memory;
  [serve_ssm]   rwkv6-7b at full width and depth 8 and jamba-v0.1-52b at
                full width, depth 8 (one period), capacity 8, through the
                bucketed Engine on 8 x 33 prompts, 16 new tokens: float,
                per-op rns9 and (Jamba) fused resident, checked as in
                [serve_archs]; rows 0 and 5 served alone give the
                batch's tokens and bit-equal final state planes; the
                ContinuousEngine refuses both with the JAX engine's
                message.  These two run after [kernels] has freed
                the other serves' recorded inputs: Jamba's 49.5 GiB of
                weights is the largest model the port holds.
  [serve_encdec] whisper-medium (2 encoder + 2 decoder layers of its
                24 + 24, over 1500 frames, cross-attention, sinusoidal
                positions) and paligemma-3b (4 of its 18 layers behind
                256 patch embeddings) at full width, random weights from
                seed 0,
                through the bucketed Engine on 8 x 33 prompts with their
                frontend frames (N(0, 1), drawn after the prompts from
                the seed-0 generator): whisper float, per-op rns9 and
                fused resident, paligemma per-op, ``rns_targets="all"``
                and fused resident, checked as in [serve_archs] (the new
                B.1-B.6 inputs -- the encoder's 8 x 1500 rows, the 8 x
                289 prefix rows, d_ff 16384 -- bit for bit); rows 0 and
                5 alone give the batch's tokens; the ContinuousEngine
                refuses both with the JAX engine's message.
  [train]       training at published width (last): smollm-135m whole,
                random weights from seed 0, [8, 128] tokens a step from
                SyntheticLM over 1024 ids, AdamW as the train CLI sets
                it, every step one captured CUDA graph (forward,
                backward with every layer recomputed, AdamW in place):
                float, 20 steps, the loss down by 0.3, the first 3 equal
                to 3 eager steps bit for bit; per-op rns9 at 16 bits with
                the RNS backward, 5 steps, step 1's loss and every
                gradient on the kernels bit-equal to the plain versions
                (``backend="reference"``) on the card, the loss within
                1e-4 of the CPU port's, ``measure_rns_ops`` = JAX's x 30;
                ``cuda_fused``, 3 steps, bit-equal to per-op; fused
                deferred with resident weights, 3 steps (B.5 and B.6
                forward, the float backward; the masters move, the
                optimizer's state holds no digits), its loss within 1e-4
                of the CPU port's; tinyllama-1.1b at full width, depth
                11 of 22, float and per-op, ``grad_accum=2``, 2 steps
                each; a Trainer resumed from
                its step-3 checkpoint bit-equal at step 4 to an
                uninterrupted one; every distinct B.1-B.6 input of the
                eager steps checked and timed (transposed operands and
                contractions over 1024 tokens among them).  Per path:
                step ms captured and eager, tokens/s, RNS kernels a step
                (the graph's kernel nodes), peak GiB.  The CPU port's
                step 1 (per-op loss and gradients, the deferred loss:
                minutes of the plain MRC) runs in a child process on
                cores of its own, started at [train]'s beginning with
                the seed-0 weights and read at its end.  Each
                warm-up's state copy goes to a reused page-locked host
                buffer (``train_step.HostStage``), not the card.
  [train_archs] the other families trained at published width (A slice
                4b), each config's ``grad_accum``, ``remat="full"``, the
                same data and optimizer, the Trainer's frontend stub:
                DeepSeek-V2 depth 1 with 16 of its 160 routed experts
                (top-6, 2 shared, capacity factor 1.25), Jamba depth 2
                (Mamba + dense, Mamba + MoE) with 4 of 16 experts,
                RWKV-6 depth 2 (chunked), whisper-medium 2 + 2 over 8 x
                1500 frames and paligemma-3b depth 4 behind 256 patches
                (TRAIN_ARCHS; every cut printed).  Each: float, 3 eager
                steps = the first 3 of 10 captured bit for bit, the loss
                after them below step 1's, the MoE aux loss positive
                where there are experts; per-op rns9 at 16 bits with the
                RNS backward, step 1's loss, aux loss and every gradient
                on the kernels bit-equal to ``backend="reference"`` on the
                card, 1 eager step (its distinct B.1-B.6 calls checked bit
                for bit and timed) = the first of 3 captured.
                DeepSeek-V2 also: ``cuda_fused`` (step 1 and 2 captured
                losses bit-equal to per-op), the resident deferred shared
                experts (B.5, B.6; every master moves, the optimizer holds
                no digits), and a Trainer resumed from a checkpoint of
                its smoke twin (a full-width checkpoint is 19.5 GB)
                bit-equal to an uninterrupted run.  Per path: step ms
                captured and eager, tokens/s, kernel nodes and RNS
                kernels a step, first step s, peak GiB, aux loss.
  [dist]        digit sharding over ranks (A.11), last, after [train]'s
                CPU child has ended: 3 gloo ranks on the one card (the
                parent empties its cache first), each holding 3 of
                rns9's 9 digits, serve smollm-135m whole, eagerly (gloo
                goes through the host: a captured gloo step raises), 3
                of the [serve] prompts (7/33/120) through
                ContinuousEngine and 8 x 33 through the bucketed Engine,
                8 new tokens each (cut for the run's time), per-op and
                with resident weights: greedy tokens equal to the
                unsharded eager serves on the card, each rank's resident
                planes [3, ...],
                one digit gather a normalize and no other collective,
                B.1 / B.2 / B.3 launched on every rank, every distinct
                B.1 and B.2 call on a digit group (3 digits) bit-equal to
                its plain version and timed, and so B.1 and B.2 on groups
                of 1, 2 and 4 digits at smollm's widths (DIST_GROUPS);
                tokens/s, decode step
                median, each rank's peak GiB and the gloo gather's host
                time; one nccl rank serves the same traffic eager and
                captured (the gather inside the CUDA graphs): equal
                tokens, one capture a program; the DP x digit train
                step on 2 x 3 gloo ranks (smollm-135m at full width,
                depth 4, per-op rns9 at 16 bits with the RNS backward)
                and float DP on the same mesh, 2 steps of [train]'s data
                against the single card's eager step: losses within rtol
                1e-5, step 1's gradients and the parameters after 2
                steps within C.17's bars (rank 0; every rank's
                parameters the same bits), one gradient all-reduce a
                step; ``compress_dci``: 3 captured steps bit-equal to 3
                eager ones (losses, parameters, m, v, error feedback).

Then it prints the card's name and power limit, the peak device memory,
one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  ``--phases=a,b`` runs only the named phases (a debugging aid).  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL_LAYERS = 30
# What the JAX engine reports as one decode step's rns_ops for smollm-135m
# rns9 (written down from tests/test_torch_serve.py, which traces the JAX
# engine on the CPU).  Its layer scan is traced once, so this is one layer;
# the port counts every call: FULL_LAYERS times these per decode step.
JAX_DECODE_RNS_OPS = {"converts": 5, "matmuls": 3, "normalizes": 3,
                      "fused": 0, "fallbacks": 0, "weight_converts": 3}
# The same for the fused path (resident weights, deferred MLP, fused
# backend), from tests/test_torch_fused.py: per layer, wi is a fused
# encode+matmul, wg a fused dot, the gate one convert, wo a fused
# matmul+normalize.
JAX_FUSED_DECODE_RNS_OPS = {"converts": 2, "matmuls": 3, "normalizes": 2,
                            "fused": 3, "fallbacks": 0, "weight_converts": 0}
FUSED_SERVE = dict(rns_backend="cuda_fused", rns_defer=True,
                   resident_weights=True)
# each serve path: its ServeConfig overrides and the JAX engine's decode
# rns_ops for one layer (the per-layer path's layers run the fused
# path's ops on their own profile)
SERVE_PATHS = {
    "serve": ({}, JAX_DECODE_RNS_OPS),
    "serve_fused": (FUSED_SERVE, JAX_FUSED_DECODE_RNS_OPS),
    "serve_per_layer": (dict(FUSED_SERVE, per_layer_profiles=True),
                        JAX_FUSED_DECODE_RNS_OPS),
}
# kernel launches of one full-width decode step on each path
DECODE_LAUNCHES = {
    "serve": {"rns_convert": 150, "rns_matmul": 90, "rns_normalize": 90,
              "rns_fused_encode_matmul": 0, "rns_fused_matmul_normalize": 0,
              "rns_fused_dot": 0, "flash_attention": 0},
    "serve_fused": {"rns_convert": 30, "rns_matmul": 0, "rns_normalize": 0,
                    "rns_fused_encode_matmul": 30,
                    "rns_fused_matmul_normalize": 30, "rns_fused_dot": 30,
                    "flash_attention": 0},
}
DECODE_LAUNCHES["serve_per_layer"] = DECODE_LAUNCHES["serve_fused"]
RNS_KERNELS = ("rns_convert", "rns_matmul", "rns_normalize",
               "rns_fused_encode_matmul", "rns_fused_matmul_normalize",
               "rns_fused_dot")
# the block table [tune] writes and [serve_tuned] serves with
TUNE_CACHE = ROOT / "build" / "chip_smoke_autotune.json"
# flash_attention at smollm-135m's attention geometry (9 query heads, 3
# KV heads of 64), at a prompt of the serve traffic and at the model's
# published 2048-token context: (B, Tq, Tk, H, Hk, D)
FLASH_FULL = [(1, 120, 120, 9, 3, 64), (1, 2048, 2048, 9, 3, 64)]
# the ragged shapes of tests/test_flash_kernel.py
FLASH_RAGGED = [(1, 128, 128, 2, 1, 16), (2, 96, 200, 4, 2, 32),
                (1, 17, 33, 2, 2, 64), (1, 130, 257, 2, 1, 32),
                (2, 7, 5, 2, 2, 16), (1, 65, 64, 2, 1, 16)]

# NVIDIA H100 SXM data-sheet peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# the tensor-core instruction each kernel's SASS must hold
SASS_MMA = {"rns_matmul": "IMMA", "rns_fused_mma": "IMMA",
            "flash_attention": "HMMA"}

SERVE = dict(requests=6, prompt_lens=(7, 33, 120), new=16, max_seqs=8)
# [serve_chunked]: the SERVE traffic through one packed mixed step of 64
# lanes with prefill chunks of at most 32 tokens, on each path; its
# tokens are held to the whole-prompt serve of the path named
CHUNKED_SERVE = dict(chunked_prefill=True, token_budget=64, chunk_size=32)
CHUNKED_PATHS = {"serve_chunked": ("serve", {}),
                 "serve_chunked_fused": ("serve_fused", FUSED_SERVE)}
# [serve_prefix]: a chat service with one system prompt -- 96 shared
# tokens (six pages), a user turn of 7-40 tokens a request, and the
# first request sent again (a regenerate); three rows at a time, so
# later requests find the prefix cached
PREFIX_SERVE = dict(seed=7, shared=96, tails=(7, 19, 40, 12, 33),
                    max_seqs=3, prompt_pad=144)
# [serve_spec]: the SERVE traffic plus one request whose prompt is a
# 16-token phrase said four times, speculative (3 drafts from 3-gram
# prompt lookup); each label -> (the serve whose path and ops it runs,
# overrides)
SPEC_SERVE = dict(spec_decode=True, spec_k=3, spec_ngram=3)
SPEC_PHRASE = dict(seed=5, length=16, times=4)
SPEC_PATHS = {"serve_spec": ("serve", {}),
              "serve_spec_fused": ("serve_fused", {}),
              "serve_spec_chunked": ("serve", CHUNKED_SERVE)}
# [serve_window]: the SERVE prompts, 96 new tokens, a 64-token window in
# a pool of 1 + 8 * (ceil(65 / 16) + 1) = 49 pages (113 hold the same
# rows unwindowed); phase-barrier and chunked, per-op
WINDOW_SERVE = dict(new=96, window_tokens=64, n_pages=49)
WINDOW_PATHS = {"serve_window": {}, "serve_window_chunked": CHUNKED_SERVE}
# [serve_bucketed]: 8 prompts of 33 tokens through the bucketed Engine;
# each label -> the serve whose path it runs
BUCKETED_SERVE = dict(batch=8, prompt_len=33, new=16)
BUCKETED_PATHS = {"serve_bucketed": "serve",
                  "serve_bucketed_fused": "serve_fused"}
# [serve_mla]: DeepSeek-V2 (arXiv:2405.04434) at its published width --
# MLA (128 heads, q_lora 1536, kv_lora 512, nope 128, rope 64, v 128),
# 160 routed experts of 1536 top-6 + 2 shared, vocab 102400, untied --
# at depth 2 of 60: float32 weights take ~15.9 GB a layer (experts 15.1)
# and 4.2 GB for the embedding and head, 36 GB of the card's 80
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 2
# >= E / k = 160 / 6: dropless, so chunked and bucketed tokens can equal
# whole-prompt ones (JAX's own reason for its dropless smoke twin)
MLA_CAPACITY = 27.0
# per layer, each RNS target: the JAX engine's (decode, prefill) rns_ops
# (from the JAX engine on the smoke twin on the CPU, as
# tests/test_torch_mla.py compares them); "all" adds the MLA projections
# (prefill also re-expands the latents through wuk/wuv)
MLA_OPS = {
    "mlp": (JAX_DECODE_RNS_OPS, JAX_DECODE_RNS_OPS),
    "all": ({"converts": 14, "matmuls": 9, "normalizes": 9, "fused": 0,
             "fallbacks": 0, "weight_converts": 9},
            {"converts": 17, "matmuls": 11, "normalizes": 11, "fused": 0,
             "fallbacks": 0, "weight_converts": 11}),
    "fused": (JAX_FUSED_DECODE_RNS_OPS, JAX_FUSED_DECODE_RNS_OPS),
}
# per layer: kernel launches of one decode (verify, mixed) step
_NONE = dict.fromkeys(RNS_KERNELS + ("flash_attention",), 0)
MLA_LAUNCHES = {
    "mlp": dict(_NONE, rns_convert=5, rns_matmul=3, rns_normalize=3),
    "all": dict(_NONE, rns_convert=14, rns_matmul=9, rns_normalize=9),
    "fused": dict(_NONE, rns_convert=1, rns_fused_encode_matmul=1,
                  rns_fused_matmul_normalize=1, rns_fused_dot=1),
}
# label -> (ops/launches key, rns_targets, ServeConfig overrides); the
# fused one last: it encodes the shared experts resident in place
MLA_PATHS = {
    "serve_mla": ("mlp", "mlp", {}),
    "serve_mla_all": ("all", "all", {}),
    "serve_mla_chunked": ("mlp", "mlp", CHUNKED_SERVE),
    "serve_mla_spec": ("mlp", "mlp", SPEC_SERVE),
    "serve_mla_fused": ("fused", "mlp", FUSED_SERVE),
}
IDENTITY_LAYERS = 4
# Card vs CPU first-step logits (|logit| <= ~2 at this config).  The two
# devices' float32 ops (attention, norms) differ in the last bits; the
# 8-bit requantization of every MLP input turns such a difference into a
# rounding flip, and flips cascade over the layers.  [identity] prints
# the size of that effect on the CPU alone (every weight of one float
# matrix moved by one ulp) and the datapath's own 8-bit error against
# plain float; the bar must sit below the latter, so that a card path
# which dropped the RNS datapath fails.
LOGIT_TOL = 0.05


def _time_ms(torch, fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed between CUDA events, so that the host's
    launch overhead (Python, ctypes) stays out of the number.  A call
    slower than 1 ms / ``iters`` is captured as many times as take about
    1 ms (once at least): the largest main-path inputs (whisper's 8 x
    1500 encoder rows) would otherwise take seconds a timing."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):              # warm: build, table caches, allocator
        fn()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(1, min(iters, int(1.0 / max(start.elapsed_time(end),
                                            1e-3))))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def _eager_ms(torch, fn, iters: int) -> float:
    """Time of one eager call, host overhead included (CUDA events around
    ``iters`` back-to-back calls): what the serving loop pays."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(torch, got, want) -> float:
    """0 when bit-equal; NaNs must sit at the same places."""
    if got.dtype.is_floating_point:
        if not torch.equal(got.isnan(), want.isnan()):
            return float("inf")
        got, want = got.nan_to_num(nan=0.0), want.nan_to_num(nan=0.0)
        same = (got == want)        # equal infs give no error
        diff = (got.double() - want.double()).abs()
        return float(torch.where(same, 0.0, diff).max())
    return float((got.long() - want.long()).abs().max())


def _register_model(entry: str):
    """The tile checker's registers per thread for one compiled entry
    (its mangled name), or None for an entry the model does not cover."""
    from repro_torch.analysis import kernel_audit as ka

    if (m := re.search(r"rns_convert_kernelILi(\d+)E(.)E", entry)):
        return ka.registers_per_thread("rns_convert", int(m[1]),
                                       res_bytes=1 if m[2] == "a" else 4)
    if (m := re.search(r"rns_normalize_kernelILi(\d+)E", entry)):
        return ka.registers_per_thread("rns_normalize", int(m[1]))
    if (m := re.search(r"rns_fused_mma_kernelI(.).Li(\d+)ELi\d+ELi(\d+)E",
                       entry)):
        kind = "rns_fused_dot" if m[1] == "f" else \
            "rns_fused_matmul_normalize"
        return ka.registers_per_thread(kind, int(m[2]),
                                       blocks={"bn": int(m[3])})
    if (m := re.search(r"rns_encode_residues_kernelI.Li(\d+)ELi\d+ELi(\d+)E",
                       entry)):
        return ka.registers_per_thread("rns_fused_encode_matmul", int(m[1]),
                                       blocks={"bn": int(m[2])})
    if "rns_matmul_kernel" in entry:
        return ka.registers_per_thread("rns_matmul")
    if "flash_attention_kernel" in entry:
        return ka.registers_per_thread("flash_attention")
    return None


def _sass_counts(lib: Path, op: str):
    """({compiled function: count of ``op`` lines}, cuobjdump's process)
    from ``cuobjdump -sass`` of one library; every function is a key."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    by_fn, fn = {}, ""
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            by_fn.setdefault(fn, 0)
        elif op in line:
            by_fn[fn] = by_fn.get(fn, 0) + 1
    return by_fn, sass


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.rns_normalize import ops as n_ops

    sources = {m.SOURCE.stem: m.SOURCE for m in _kernel_mods().values()}

    def one(name):              # one nvcc each, all started together
        t = time.perf_counter()
        log = build.build_all({name: sources[name]})[name]
        return log, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        done = dict(zip(sources, pool.map(one, sources)))
    logs = {name: log for name, (log, _) in done.items()}
    print(f"[build] ok in {time.perf_counter() - t0:.1f}s: "
          f"{len(logs)} libraries (" + ", ".join(
              f"{n} {t:.1f}s" for n, (_, t) in sorted(done.items())) + ")")
    over = []
    for name, log in sorted(logs.items()):   # one line per compiled kernel
        entry = spill = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif "registers" in line and entry:
                regs = int(line.split("Used")[1].split("registers")[0])
                model = _register_model(entry)
                print(f"  {name}: {entry} {regs} registers (model "
                      f"{model}), {spill}")
                if model is None or regs > model:
                    over.append(f"{name} {entry}: {regs} > {model}")
    if over:
        raise AssertionError("instantiations over the tile checker's "
                             "register model:\n" + "\n".join(over))
    dumps = {name: (build.library_path(name, sources[name]), op)
             for name, op in [*SASS_MMA.items(), ("rns_normalize",
                                                   "MUFU.RCP")]}
    with ThreadPoolExecutor(len(dumps)) as pool:     # cuobjdumps at once
        sasses = dict(zip(dumps, pool.map(lambda d: _sass_counts(*d),
                                          dumps.values())))
    for name, op in SASS_MMA.items():
        lib = dumps[name][0]
        by_fn, sass = sasses[name]
        counts = {name: sum(by_fn.values())}
        if name == "rns_fused_mma":     # B.5's instantiations on their own
            counts["rns_encode_residues_kernel"] = sum(
                n for f, n in by_fn.items()
                if "rns_encode_residues_kernel" in f)
        for what, n in counts.items():
            print(f"  {what}: {n} {op} instructions in the SASS "
                  f"(cuobjdump -sass {lib.name})")
            if not n:
                raise AssertionError(
                    f"{what}: no {op} instruction in its SASS (cuobjdump rc "
                    f"{sass.returncode}: {sass.stderr.strip()[:200]})")
    # B.3's MRC reduces by multiply-high mods: no division, whose
    # reciprocal (MUFU.RCP) would show in the SASS
    lib = dumps["rns_normalize"][0]
    by_fn, sass = sasses["rns_normalize"]
    n = sum(by_fn.values())
    print(f"  rns_normalize: {n} MUFU.RCP instructions in the SASS of "
          f"{len(by_fn)} functions (cuobjdump -sass {lib.name})")
    if sass.returncode or len(by_fn) < len(n_ops.SUPPORTED_K) or n:
        raise AssertionError(
            f"rns_normalize: {n} MUFU.RCP in {len(by_fn)} functions, want 0 "
            f"in at least {len(n_ops.SUPPORTED_K)} (cuobjdump rc "
            f"{sass.returncode}: {sass.stderr.strip()[:200]})")


def _kernel_mods():
    """{kernel (wrapper) name: ops module}; the module's ``launches`` is
    an int, or a dict by wrapper name for the fused kernels."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rns_convert import ops as c_ops
    from repro_torch.kernels.rns_fused import ops as f_ops
    from repro_torch.kernels.rns_matmul import ops as m_ops
    from repro_torch.kernels.rns_normalize import ops as n_ops

    return {"rns_convert": c_ops, "rns_matmul": m_ops,
            "rns_normalize": n_ops, "rns_fused_encode_matmul": f_ops,
            "rns_fused_matmul_normalize": f_ops, "rns_fused_dot": f_ops,
            "flash_attention": fa_ops}


def _launches() -> dict:
    out = {}
    for name, mod in _kernel_mods().items():
        n = mod.launches
        out[name] = n[name] if isinstance(n, dict) else n
    return out


def _reset_launches():
    for name, mod in _kernel_mods().items():
        if isinstance(mod.launches, dict):
            mod.launches[name] = 0
        else:
            mod.launches = 0


def _residues(torch, p, shape, g, dev):
    return torch.stack([torch.randint(0, m, shape, generator=g, device=dev)
                        for m in p.moduli]).to(torch.int32)


def _cost(torch, kernel, K, args, kw):
    """(label, bytes, ops, rate) of one call: each input read once, each
    output written once; matmul ops at the int8 rate."""
    if kernel == "rns_convert":
        x, s = args
        T = x.numel()
        out_bytes = 1 if kw.get("out_dtype", torch.int8) == torch.int8 \
            else 4
        return (f"x{list(x.shape)} scale{list(s.shape)}",
                x.element_size() * T + 4 * s.numel() + K * T * out_bytes,
                T, F32_OPS_PER_S)
    if kernel == "rns_normalize":
        r, = args
        T = r[0].numel()
        return (f"{list(r.shape)}", r.element_size() * K * T + 4 * T,
                2 * K * T, F32_OPS_PER_S)
    if kernel in ("rns_matmul", "rns_fused_matmul_normalize"):
        a, b = args
        _, D, N = b.shape
        M = a.numel() // (K * D)
        out = K * M * N * 4 if kernel == "rns_matmul" else M * N * 4
        return (f"{list(a.shape)}{a.dtype}@{list(b.shape)}",
                a.element_size() * K * M * D + b.element_size() * K * D * N
                + out, 2 * K * M * N * D, INT8_OPS_PER_S)
    x, s, b = args                  # rns_fused_encode_matmul / rns_fused_dot
    _, D, N = b.shape
    M = x.numel() // D
    out = K * M * N * 4 if kernel == "rns_fused_encode_matmul" else M * N * 4
    return (f"x{list(x.shape)} scale{list(s.shape)}@{list(b.shape)}",
            4 * M * D + 4 * s.numel() + b.element_size() * K * D * N + out,
            2 * K * M * N * D, INT8_OPS_PER_S)


def _flash_inputs(torch, dev, shape, dtype, seed):
    """q [B,Tq,H,D], k and v [B,Tk,Hk,D], standard normal from ``seed``."""
    B, Tq, Tk, H, Hk, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device=dev).to(dtype)
                 for s in ((B, Tq, H, D), (B, Tk, Hk, D), (B, Tk, Hk, D)))


def _blk(blocks) -> str:
    return "/".join(f"{k}{v}" for k, v in blocks.items())


def phase_tune(torch, dev, calls, launches, tuned):
    """Tune every kind at every bucket of the recorded main-path calls
    (on the call of each bucket called most) and flash_attention at
    FLASH_FULL, into the fresh table TUNE_CACHE; fills ``tuned``
    (bucket -> default and tuned blocks, each candidate's time)."""
    from repro_torch.kernels import autotune, wrappers

    if not calls:
        raise AssertionError("no main-path calls recorded: nothing to tune")
    fns = wrappers()
    by_bucket = {}          # bucket key -> (kind, profile, (args, kw))
    for entry in sorted(calls.values(), key=lambda e: -e["calls"]):
        kind = entry["kernel"]
        fns[kind][0](entry["profile"], *entry["args"], **entry["kw"])
        by_bucket.setdefault(autotune.last_launch[kind][0], (
            kind, entry["profile"], (entry["args"], entry["kw"])))
    for i, shape in enumerate(FLASH_FULL):
        qkv = _flash_inputs(torch, dev, shape, torch.float32, 10 + i)
        fns["flash_attention"][0]("float32", *qkv, causal=True)
        by_bucket.setdefault(autotune.last_launch["flash_attention"][0], (
            "flash_attention", "float32", (qkv, {"causal": True})))
    torch.cuda.synchronize()
    _reset_launches()
    for bucket, (kind, prof, call) in by_bucket.items():
        shape = tuple(int(d) for d in bucket.split("|")[2].split("x"))
        bench = autotune.default_bench(kind, prof, shape, "cuda", call=call)
        times: dict = {}

        def timed(blocks, bench=bench, times=times):
            t = bench(blocks)
            times[_blk(blocks)] = min(t, times.get(_blk(blocks), t))
            return t

        best = autotune.tune(kind, prof, shape, "cuda", bench_fn=timed)
        _, dropped = autotune.legal_candidates(kind, prof, shape)
        default = autotune.DEFAULTS[kind]
        tuned[bucket] = {
            "kind": kind, "default": dict(default), "tuned": best,
            "default_us": (times[_blk(default)] * 1e6
                           if _blk(default) in times else None),
            "tuned_us": times[_blk(best)] * 1e6,
            "us": {k: v * 1e6 for k, v in times.items()},
            "dropped": [[c, why] for c, why in dropped]}
        print(f"  {bucket}: " + " ".join(
            f"{k}={v * 1e6:.2f}us" for k, v in times.items())
            + f" -> {_blk(best)} (default {_blk(default)})")
        for cand, why in dropped:
            print(f"    dropped {cand}: {why}")
    torch.cuda.synchronize()
    launches["tune"] = run = _launches()
    rows = json.loads(TUNE_CACHE.read_text())["entries"]
    missing = sorted(set(by_bucket) - set(rows))
    if missing:
        raise AssertionError(f"no table row for {missing}")
    kinds = {v[0] for v in by_bucket.values()}
    if kinds != set(autotune.DEFAULTS) or not all(run.values()):
        raise AssertionError(f"tuned kinds {sorted(kinds)}, launches {run}")
    print(f"[tune] ok: {len(by_bucket)} rows in {TUNE_CACHE.name} for "
          f"{len(kinds)} kinds; launches {run}")


@contextlib.contextmanager
def _table(path: Path):
    """Resolve tiles through the block table at ``path`` (a missing file
    is an empty table: the defaults)."""
    from repro_torch.kernels import autotune

    saved = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(path)
    autotune.clear_cache()
    try:
        yield
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.clear_cache()


METRICS = ("tokens_per_s", "ttft_p50_s", "decode_step_ms_median",
           "device_busy_ms")


def phase_serve_tuned(torch, launches, calls, untuned):
    """Each serve path once more, eager and captured, with engines built
    under the table [tune] wrote: tokens bit-equal to the untuned
    serves, every launch on its bucket's row, the numbers beside the
    untuned run's."""
    for path in SERVE_PATHS:
        if path not in untuned:
            raise AssertionError(f"[{path}] did not run: nothing to "
                                 "compare with")
        base, base_tokens = untuned[path]
        with _table(TUNE_CACHE):
            run, tokens = phase_serve(torch, path, launches, calls,
                                      rerun="tuned")
        if tokens != base_tokens:
            raise AssertionError(f"{path} tuned: greedy tokens differ from "
                                 "the untuned serve's")
        for mode in ("eager", "captured"):
            for name in METRICS:
                print(f"  {path} {mode} {name}: untuned "
                      f"{base[mode].get(name, 'not measured')}, tuned "
                      f"{run[mode].get(name, 'not measured')}")
        print(f"  {path}: launches per decode step "
              f"{run['eager']['rns_kernels_per_decode_step']} eager, "
              f"{run['captured']['rns_kernels_per_decode_step']} replayed; "
              "greedy tokens bit-equal to the untuned serve")


def phase_serve_per_layer(torch, launches, calls, untuned):
    """The fused path with per-layer profiles, eager and captured: one
    profile for the layers' one period slot, narrower than rns9, and
    greedy tokens equal to [serve_fused]'s (a resident chain on a
    narrower profile computes the same integers)."""
    untuned["serve_per_layer"] = run, tokens = phase_serve(
        torch, "serve_per_layer", launches, calls)
    profiles = run["profiles"]
    if len(profiles) != 1 or "rns9" in profiles:
        raise AssertionError(f"per-layer profiles {profiles}: want one "
                             "profile narrower than rns9")
    if "serve_fused" not in untuned:
        raise AssertionError("[serve_fused] did not run: nothing to "
                             "compare with")
    if tokens != untuned["serve_fused"][1]:
        raise AssertionError("per-layer greedy tokens differ from "
                             "[serve_fused]'s")
    print(f"  serve_per_layer: profiles {profiles}; greedy tokens equal to "
          "[serve_fused]'s")


def _merge_calls(calls: dict, path_calls: dict):
    """Add one serve's recorded wrapper calls to ``calls``."""
    for key, entry in path_calls.items():
        if key in calls:
            calls[key]["calls"] += entry["calls"]
        else:
            calls[key] = entry


def _mixed_numbers(stats) -> dict:
    steps = stats["steps"]
    mixed = [s for s in steps if s["prefill_tokens"] and s["decode_tokens"]]
    return {
        "mixed_steps": len(mixed),
        "step_ms_median": 1e3 * statistics.median(
            s["step_time_s"] for s in steps),
        "mixed_step_ms_median": (1e3 * statistics.median(
            s["step_time_s"] for s in mixed) if mixed else None),
        "ttft_p95_s": stats["ttft_p95_s"],
        "prefill_tokens": sum(s["prefill_tokens"] for s in steps)}


def phase_serve_chunked(torch, launches, calls, untuned):
    """The [serve] traffic through chunked prefill (CHUNKED_SERVE: every
    step one packed mixed step of 64 lanes, chunks of 32), on the
    per-op and the fused path, eager then captured.  The eager serve
    runs with counts from 0 and every distinct wrapper call recorded and
    merged into ``calls`` (the packed shapes [kernels] checks and
    times); every step runs the mixed program once, so each step's
    launches are the path's decode step's.  The captured serve captures
    one mixed program across every phase mix.  Greedy tokens equal the
    whole-prompt serve's ([serve], [serve_fused])."""
    from repro_torch.launch.serve import serve

    out = {}
    for label, (base, serve_kw) in CHUNKED_PATHS.items():
        if base not in untuned:
            raise AssertionError(f"[{base}] did not run: nothing to compare "
                                 "with")
        per_step = {k: v * FULL_LAYERS
                    for k, v in SERVE_PATHS[base][1].items()}
        want_launch = DECODE_LAUNCHES[base]
        _reset_launches()
        steps_log: list = []
        path_calls: dict = {}
        in_step: dict = {}
        t0 = time.perf_counter()
        with _recording(torch, path_calls, None, in_step), \
                _step_launches(steps_log, in_step):
            engine, results, stats = serve(
                "smollm-135m", full=True, rns="rns9", device="cuda",
                graphs=False, **SERVE, **CHUNKED_SERVE, **serve_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = run = _launches()
        steps = stats["steps"]
        if set(engine.programs) != {"mixed"}:
            raise AssertionError(f"{label}: programs {sorted(engine.programs)}")
        for st in steps:            # the JAX engine's rule: mixed each step
            if st["rns_ops"].as_dict() != per_step:
                raise AssertionError((label, st["step"], st["rns_ops"]))
        for st, lc in steps_log:
            if lc != want_launch:
                raise AssertionError((label, st["step"], lc))
        for k, n in run.items():
            if (n > 0) != (want_launch[k] > 0):
                raise AssertionError((label, k, n))
        if not any(st["prefill_tokens"] and st["decode_tokens"]
                   for st in steps):
            raise AssertionError(f"{label}: no step mixed both phases")
        _merge_calls(calls, path_calls)
        tokens = _tokens(results)
        if tokens != untuned[base][1]:
            raise AssertionError(f"{label}: eager greedy tokens differ from "
                                 f"[{base}]'s (whole-prompt prefill)")
        eager = _serve_numbers(engine, stats, wall, steps_log[-1][1])
        eager.update(_mixed_numbers(stats), launches=dict(run),
                     distinct_calls=len(path_calls),
                     rns_kernels_per_step=sum(want_launch.values()))
        del engine

        t0 = time.perf_counter()
        cengine, cresults, cstats = serve(
            "smollm-135m", full=True, rns="rns9", device="cuda", graphs=True,
            **SERVE, **CHUNKED_SERVE, **serve_kw)
        torch.cuda.synchronize()
        cwall = time.perf_counter() - t0
        if _tokens(cresults) != tokens:
            raise AssertionError(f"{label}: captured greedy tokens differ "
                                 "from the eager serve's")
        if [st["rns_ops"].as_dict() for st in cstats["steps"]] != [
                st["rns_ops"].as_dict() for st in steps]:
            raise AssertionError(f"{label}: captured rns_ops differ")
        if cstats["captures"] != {"mixed": 1}:
            raise AssertionError(f"{label}: captures {cstats['captures']}")
        captured = _serve_numbers(cengine, cstats, cwall, None)
        captured.update(_mixed_numbers(cstats))
        captured.update(_profile_serve(torch, cengine, cresults,
                                       cstats["wall_s"]))
        if cengine.captures() != {"mixed": 1}:
            raise AssertionError(f"{label}: re-serve recaptured: "
                                 f"{cengine.captures()}")
        replay = _replay_kernels(torch, cengine, "mixed")
        captured["replayed_mixed_step"] = replay
        captured["rns_kernels_per_step"] = replay["rns_kernels"]
        want_rns = {k: n for k, n in want_launch.items() if n}
        if replay["by_kernel"] != want_rns:
            raise AssertionError(f"{label}: a replayed mixed step ran "
                                 f"{replay['by_kernel']}, want {want_rns}")
        _print_top(f"{label} mixed", replay)
        del cengine
        out[label] = {"eager": eager, "captured": captured}
        print(json.dumps({label: out[label]}))
        for name in SIDE_BY_SIDE + ("mixed_step_ms_median", "step_ms_median",
                                    "mixed_steps"):
            print(f"  {label} {name}: eager {eager.get(name, 'not measured')}"
                  f", captured {captured.get(name, 'not measured')}")
        print(f"  {label}: greedy tokens equal to [{base}]'s, captures "
              f"{cstats['captures']}")
    return out


def _prefix_prompts(vocab: int):
    """PREFIX_SERVE's traffic: one system prompt, a user turn a request,
    and a regenerate of the first request as the last."""
    import numpy as np

    rng = np.random.default_rng(PREFIX_SERVE["seed"])
    system = rng.integers(0, vocab, (PREFIX_SERVE["shared"],))
    prompts = [np.concatenate([system, rng.integers(0, vocab, (n,))]).astype(
        np.int32) for n in PREFIX_SERVE["tails"]]
    return prompts + [prompts[0].copy()]


def phase_serve_prefix(torch, launches):
    """Shared-prefix traffic (PREFIX_SERVE) on the per-op path, captured:
    without the prefix cache (the reference), with it phase-barrier
    (prompt_pad 144), and with it chunked.  Greedy tokens equal the
    uncached serve's; the cached serves share pages, serve cached
    tokens and split the regenerate's partial tail copy-on-write."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve

    prompts = _prefix_prompts(get_config("smollm-135m").vocab)
    common = dict(full=True, rns="rns9", device="cuda", graphs=True,
                  prompts=prompts, new=SERVE["new"],
                  max_seqs=PREFIX_SERVE["max_seqs"])
    runs = {
        "uncached": dict(prompt_pad=PREFIX_SERVE["prompt_pad"]),
        "cached": dict(prompt_pad=PREFIX_SERVE["prompt_pad"],
                       prefix_cache=True),
        "cached_chunked": dict(prefix_cache=True, **CHUNKED_SERVE),
    }
    want_captures = {"uncached": {"decode": 1, "prefill": 1},
                     "cached": {"decode": 1, "prefill": 1, "cow": 1},
                     "cached_chunked": {"mixed": 1, "cow": 1}}
    _reset_launches()
    out, ref = {}, None
    for name, kw in runs.items():
        t0 = time.perf_counter()
        engine, results, stats = serve("smollm-135m", **common, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = _tokens(results)
        ref = tokens if ref is None else ref
        row = {k: stats[k] for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p95_s", "wall_s", "n_steps",
            "cache_hit_tokens", "pages_shared", "pages_allocated",
            "cow_splits", "captures")}
        row.update(setup_and_run_s=wall, prompt_pad=engine.prompt_pad,
                   prefill_tokens=sum(s["prefill_tokens"]
                                      for s in stats["steps"]))
        out[name] = row
        print(f"  serve_prefix {name}: " + " ".join(
            f"{k}={v}" for k, v in row.items()))
        if stats["captures"] != want_captures[name]:
            raise AssertionError(f"serve_prefix {name}: captures "
                                 f"{stats['captures']}")
        if tokens != ref:
            raise AssertionError(f"serve_prefix {name}: greedy tokens differ "
                                 "from the uncached serve's")
        if name != "uncached" and min(row["cache_hit_tokens"],
                                      row["pages_shared"],
                                      row["cow_splits"]) <= 0:
            raise AssertionError(f"serve_prefix {name}: no sharing: {row}")
        if tokens[len(prompts) - 1] != tokens[0]:
            raise AssertionError("serve_prefix: the regenerate differs")
        del engine
    launches["prefix"] = _launches()
    print(json.dumps({"serve_prefix": out}))
    print("  serve_prefix: greedy tokens equal to the uncached serve's, "
          "phase-barrier and chunked")
    return out


def _spec_prompts(vocab: int):
    """[serve_spec]'s traffic: the SERVE prompts and one prompt that is a
    16-token phrase said four times."""
    import numpy as np

    from repro_torch.launch.serve import request_prompts

    rng = np.random.default_rng(SPEC_PHRASE["seed"])
    phrase = rng.integers(0, vocab, (SPEC_PHRASE["length"],))
    return request_prompts(vocab, SERVE["requests"], SERVE["prompt_lens"]) + [
        np.tile(phrase, SPEC_PHRASE["times"]).astype(np.int32)]


def _served_twice(torch, label, launches, calls, serve_kw, *, base,
                  want_captures, program, per_step_ops, check_step):
    """One continuous serve path eager (counts from 0, every distinct
    wrapper call recorded and merged into ``calls``, each step's
    launches logged), then captured: the same tokens and rns_ops, the
    captures ``want_captures``, and one replayed ``program`` step
    running the kernels of ``base``'s decode step.  ``check_step(stats,
    launches)`` holds each eager step; ``per_step_ops(stats)`` is the
    step's rns_ops.  Returns (numbers, tokens, captured stats)."""
    from repro_torch.launch.serve import serve

    want_launch = DECODE_LAUNCHES[base]
    _reset_launches()
    steps_log: list = []
    path_calls: dict = {}
    in_step: dict = {}
    t0 = time.perf_counter()
    with _recording(torch, path_calls, None, in_step), \
            _step_launches(steps_log, in_step):
        engine, results, stats = serve("smollm-135m", full=True, rns="rns9",
                                       device="cuda", graphs=False,
                                       **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[label] = run = _launches()
    for st in stats["steps"]:
        if st["rns_ops"].as_dict() != per_step_ops(st):
            raise AssertionError((label, st["step"], st["rns_ops"]))
        if st["rns_ops"].fallbacks:
            raise AssertionError((label, st["step"], "fallbacks"))
    checked = [lc for st, lc in steps_log if check_step(st, lc)]
    if not checked:
        raise AssertionError(f"{label}: no step to hold to {base}'s "
                             "launches")
    for k, n in run.items():
        if (n > 0) != (want_launch[k] > 0):
            raise AssertionError((label, k, n))
    _merge_calls(calls, path_calls)
    tokens = _tokens(results)
    eager = _serve_numbers(engine, stats, wall, checked[0])
    eager.update(launches=dict(run), distinct_calls=len(path_calls),
                 rns_kernels_per_decode_step=sum(checked[0].values()))
    del engine

    t0 = time.perf_counter()
    cengine, cresults, cstats = serve("smollm-135m", full=True, rns="rns9",
                                      device="cuda", graphs=True, **serve_kw)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    if _tokens(cresults) != tokens:
        raise AssertionError(f"{label}: captured greedy tokens differ from "
                             "the eager serve's")
    if [st["rns_ops"].as_dict() for st in cstats["steps"]] != [
            st["rns_ops"].as_dict() for st in stats["steps"]]:
        raise AssertionError(f"{label}: captured rns_ops differ")
    if cstats["captures"] != want_captures:
        raise AssertionError(f"{label}: captures {cstats['captures']}")
    captured = _serve_numbers(cengine, cstats, cwall, None)
    replay = _replay_kernels(torch, cengine, program)
    captured["rns_kernels_per_decode_step"] = replay["rns_kernels"]
    want_rns = {k: n for k, n in want_launch.items() if n}
    if replay["by_kernel"] != want_rns:
        raise AssertionError(f"{label}: a replayed {program} step ran "
                             f"{replay['by_kernel']}, want {want_rns}")
    captured[f"replayed_{program}_step_device_ms"] = replay["device_ms"]
    captured[f"replayed_{program}_step_kernels"] = replay["all_kernels"]
    del cengine
    return {"eager": eager, "captured": captured}, tokens, cstats


def _print_numbers(label, out, extra=()):
    print(json.dumps({label: out}))
    for name in ("tokens_per_s", "ttft_p50_s", "decode_step_ms_median",
                 "captures", "rns_kernels_per_decode_step") + tuple(extra):
        print(f"  {label} {name}: eager "
              f"{out['eager'].get(name, 'not measured')}, captured "
              f"{out['captured'].get(name, 'not measured')}")


def phase_serve_spec(torch, launches, calls, untuned):
    """Speculative decoding (SPEC_SERVE) of the [serve] traffic and a
    repeated phrase, per-op and fused phase-barrier and per-op chunked,
    eager then captured.  A verify step (or a mixed step) launches the
    kernels of its path's decode step; captures ``verify=1 prefill=1``
    (``mixed=1`` chunked).  Greedy tokens equal the same prompts served
    without speculation on the same path (captured), whose first six
    equal [serve]'s / [serve_fused]'s."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve

    prompts = _spec_prompts(get_config("smollm-135m").vocab)
    common = dict(prompts=prompts, new=SERVE["new"],
                  max_seqs=SERVE["max_seqs"])
    plain = {}
    for base in ("serve", "serve_fused"):
        if base not in untuned:
            raise AssertionError(f"[{base}] did not run: nothing to compare "
                                 "with")
        _, res, _ = serve("smollm-135m", full=True, rns="rns9",
                          device="cuda", graphs=True, **common,
                          **SERVE_PATHS[base][0])
        plain[base] = _tokens(res)
        if plain[base][:SERVE["requests"]] != untuned[base][1]:
            raise AssertionError(f"{base}: the plain serve of the spec "
                                 f"traffic differs from [{base}]'s")
    out = {}
    for label, (base, kw) in SPEC_PATHS.items():
        chunked = bool(kw.get("chunked_prefill"))
        per_step = {k: v * FULL_LAYERS
                    for k, v in SERVE_PATHS[base][1].items()}

        def ops(st, per_step=per_step, chunked=chunked):
            n = 1 if chunked else 1 + len(st["admitted"])
            return {k: v * n for k, v in per_step.items()}

        def check(st, lc, base=base, chunked=chunked, label=label):
            if not chunked and (st["admitted"] or not st["decoded"]):
                return False
            if lc != DECODE_LAUNCHES[base]:
                raise AssertionError((label, st["step"], lc))
            return True

        want_cap = {"mixed": 1} if chunked else {"verify": 1, "prefill": 1}
        numbers, tokens, cstats = _served_twice(
            torch, label, launches, calls,
            dict(common, **SPEC_SERVE, **SERVE_PATHS[base][0], **kw),
            base=base, want_captures=want_cap,
            program="mixed" if chunked else "verify", per_step_ops=ops,
            check_step=check)
        if tokens != plain[base]:
            raise AssertionError(f"{label}: speculative greedy tokens differ "
                                 f"from the plain {base} serve's")
        numbers["captured"].update(
            tokens_per_step=cstats["tokens_per_step"],
            acceptance_rate=cstats["acceptance_rate"],
            spec_proposed=sum(st["spec_proposed"] for st in cstats["steps"]),
            spec_accepted=sum(st["spec_accepted"] for st in cstats["steps"]))
        if numbers["captured"]["tokens_per_step"] < 1.0:
            raise AssertionError(f"{label}: tokens_per_step "
                                 f"{numbers['captured']['tokens_per_step']}")
        out[label] = numbers
        _print_numbers(label, numbers, ("tokens_per_step", "acceptance_rate",
                                        "steps"))
        print(f"  {label}: greedy tokens equal to the plain {base} serve's, "
              f"captures {want_cap}")
    return out


def phase_serve_window(torch, launches, calls):
    """Sliding-window serving (WINDOW_SERVE: 96 new tokens, a 64-token
    window, 49 pages) of the SERVE prompts, per-op, phase-barrier and
    chunked, eager then captured: pages recycled by the window, and each
    request's greedy tokens equal to the windowed bucketed Engine's
    captured solo run of its prompt."""
    import numpy as np

    from repro_torch.launch.serve import build_model, request_prompts
    from repro_torch.serve.engine import Engine, ServeConfig

    model = build_model("smollm-135m", full=True, rns="rns9", device="cuda")
    prompts = request_prompts(model.cfg.vocab, SERVE["requests"],
                              SERVE["prompt_lens"])
    new, W = WINDOW_SERVE["new"], WINDOW_SERVE["window_tokens"]
    solo = Engine(model, ServeConfig(
        max_cache=max(SERVE["prompt_lens"]) + new + 8, max_new_tokens=new,
        window_tokens=W), device="cuda")
    t0 = time.perf_counter()
    want = [solo.generate(np.asarray(p)[None])[0].tolist() for p in prompts]
    solo_s = time.perf_counter() - t0
    if set(solo.captures().values()) != {1}:
        raise AssertionError(f"windowed solo captures {solo.captures()}")
    del solo, model
    per_step = {k: v * FULL_LAYERS for k, v in JAX_DECODE_RNS_OPS.items()}
    out = {"solo_runs_s": solo_s}
    for label, kw in WINDOW_PATHS.items():
        chunked = bool(kw.get("chunked_prefill"))

        def ops(st, chunked=chunked):
            n = 1 if chunked else 1 + len(st["admitted"])
            return {k: v * n for k, v in per_step.items()}

        def check(st, lc, chunked=chunked, label=label):
            if not chunked and (st["admitted"] or not st["decoded"]):
                return False
            if lc != DECODE_LAUNCHES["serve"]:
                raise AssertionError((label, st["step"], lc))
            return True

        want_cap = {"mixed": 1} if chunked else {"decode": 1, "prefill": 1}
        numbers, tokens, cstats = _served_twice(
            torch, label, launches, calls,
            dict(requests=SERVE["requests"], prompt_lens=SERVE["prompt_lens"],
                 max_seqs=SERVE["max_seqs"], **WINDOW_SERVE, **kw),
            base="serve", want_captures=want_cap,
            program="mixed" if chunked else "decode", per_step_ops=ops,
            check_step=check)
        evicted = cstats["pages_window_evicted"]
        numbers["captured"].update(
            pages_window_evicted=evicted, n_pages=WINDOW_SERVE["n_pages"],
            n_preemptions=cstats["n_preemptions"],
            peak_page_utilization=max(s["page_utilization"]
                                      for s in cstats["steps"]))
        if evicted <= 0:
            raise AssertionError(f"{label}: no page recycled by the window")
        if tokens != want:
            raise AssertionError(f"{label}: windowed greedy tokens differ "
                                 "from the windowed bucketed solo runs")
        out[label] = numbers
        _print_numbers(label, numbers, ("pages_window_evicted",
                                        "n_preemptions", "steps"))
        print(f"  {label}: {evicted} pages recycled in a pool of "
              f"{WINDOW_SERVE['n_pages']}; greedy tokens equal to the "
              "windowed bucketed solo runs")
    return out


@contextlib.contextmanager
def _engine_runs(log: list, in_step: dict):
    """Append (program name, kernel launches) for every program run of
    the bucketed Engine in the block; ``in_step["on"]`` is True while
    one runs (its build's warm-ups are not runs)."""
    from repro_torch.serve.engine import Engine

    run = Engine._run

    def counted(self, prog, **values):
        before = _launches()
        in_step["on"] = True
        try:
            out = run(self, prog, **values)
        finally:
            in_step["on"] = False
        after = _launches()
        log.append((prog, {k: after[k] - before[k] for k in after}))
        return out

    Engine._run = counted
    try:
        yield log
    finally:
        Engine._run = run


def phase_serve_bucketed(torch, launches, calls):
    """The bucketed Engine (BUCKETED_SERVE: 8 prompts of 33 tokens) on
    the per-op and the fused resident path, eager (counts from 0, every
    distinct wrapper call recorded and merged into ``calls``: the dense
    [8,33,.] and [8,1,.] shapes) then captured: ``prefill(8,33)=1
    decode(8)=1``, the same tokens, each decode step launching its
    path's decode kernels, the programs' rns_ops its path's; greedy
    tokens equal to the ContinuousEngine's on the same prompts."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import serve, serve_bucketed

    B, T, new = (BUCKETED_SERVE[k] for k in ("batch", "prompt_len", "new"))
    out = {}
    for label, base in BUCKETED_PATHS.items():
        per_step = {k: v * FULL_LAYERS
                    for k, v in SERVE_PATHS[base][1].items()}
        want_launch = DECODE_LAUNCHES[base]
        names = (f"prefill({B},{T})", f"decode({B})")
        numbers, tokens = {}, {}
        for graphs in (False, True):
            _reset_launches()
            log: list = []
            path_calls: dict = {}
            in_step: dict = {}
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if not graphs:
                    stack.enter_context(_recording(torch, path_calls, None,
                                                   in_step))
                stack.enter_context(_engine_runs(log, in_step))
                engine, toks, stats = serve_bucketed(
                    "smollm-135m", full=True, rns="rns9", device="cuda",
                    graphs=graphs, **BUCKETED_SERVE, **SERVE_PATHS[base][0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mode = "captured" if graphs else "eager"
            caps = engine.captures()
            want_caps = {n: int(graphs) for n in names}
            if caps != want_caps:
                raise AssertionError(f"{label} {mode}: captures {caps}")
            for name in names:
                if engine.programs[name].ops.as_dict() != per_step:
                    raise AssertionError((label, name,
                                          engine.programs[name].ops))
            steps = [lc for prog, lc in log if prog == names[1]]
            if not graphs:
                launches[label] = run = _launches()
                if any(lc != want_launch for lc in steps) or not steps:
                    raise AssertionError(f"{label}: decode step launches "
                                         f"{steps[:1]}, want {want_launch}")
                for k, n in run.items():
                    if (n > 0) != (want_launch[k] > 0):
                        raise AssertionError((label, k, n))
                _merge_calls(calls, path_calls)
            else:
                replay = _replay_kernels(torch, engine, names[1])
                if replay["by_kernel"] != {k: n for k, n in
                                           want_launch.items() if n}:
                    raise AssertionError(f"{label}: a replayed decode step "
                                         f"ran {replay['by_kernel']}")
            tokens[mode] = toks.tolist()
            numbers[mode] = {
                "tokens_per_s": stats["warm"]["tokens_per_s"],
                "first_call_tokens_per_s": stats["first"]["tokens_per_s"],
                "ttft_p50_s": stats["ttft_s"],
                "decode_step_ms_median": 1e3 * statistics.median(
                    stats["step_time_s"]),
                "captures": caps, "setup_and_run_s": wall,
                "rns_kernels_per_decode_step": (
                    sum(steps[0].values()) if not graphs
                    else replay["rns_kernels"]),
                "rns_op_counts": engine.rns_op_counts(B, T).as_dict()}
            del engine
        if tokens["captured"] != tokens["eager"]:
            raise AssertionError(f"{label}: captured greedy tokens differ "
                                 "from the eager run's")
        prompts = np.random.default_rng(0).integers(
            0, get_config("smollm-135m").vocab, (B, T)).astype(np.int32)
        _, res, cstats = serve("smollm-135m", full=True, rns="rns9",
                               device="cuda", graphs=True,
                               prompts=list(prompts), new=new, max_seqs=B,
                               **SERVE_PATHS[base][0])
        if _tokens(res) != tokens["captured"]:
            raise AssertionError(f"{label}: bucketed greedy tokens differ "
                                 "from the ContinuousEngine's")
        numbers["continuous_captured_tokens_per_s"] = cstats["tokens_per_s"]
        out[label] = numbers
        _print_numbers(label, numbers)
        print(f"  {label}: greedy tokens equal to the ContinuousEngine's; "
              f"captures {numbers['captured']['captures']}")
    return out


def _mla_model():
    """DeepSeek-V2 at full width, depth MLA_LAYERS, dropless, rns9 (qx =
    qw = 8) on the shared experts, random weights from seed 0 drawn on
    the card."""
    from repro_torch.configs.base import at_depth, get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.models.model import init_model

    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(
        at_depth(full, MLA_LAYERS),
        moe=dataclasses.replace(full.moe, capacity_factor=MLA_CAPACITY),
        rns=RnsDotConfig(profile="rns9", qx=8, qw=8), rns_targets="mlp")
    return init_model(cfg, seed=0, device="cuda")


def phase_serve_mla(torch, launches, calls):
    """DeepSeek-V2 at its published width (depth 2) through the engines:
    the [serve] traffic on the per-op path (shared experts through B.1-
    B.3), with rns_targets="all" (the MLA projections too), chunked (64
    lanes), speculative (3 drafts) and on the fused resident path (B.1,
    B.4-B.6), each eager (counts from 0, every distinct wrapper call
    recorded into ``calls`` for [kernels], each decode / verify / mixed
    step's launches the path's) then captured (one capture a program,
    the eager tokens and rns_ops, a replayed decode step's kernels);
    tokens chunked = speculative = whole-prompt; the bucketed Engine on
    8 x 33 eager and captured, its tokens the ContinuousEngine's; the
    first prefill's logits on the kernels bit-equal to the plain
    ("reference") RNS path on the card, finite, of shape [1, vocab]."""
    import gc

    import numpy as np

    from repro_torch.launch.serve import request_prompts
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _mla_model()
    torch.cuda.synchronize()
    cfg0 = model.cfg
    m, moe = cfg0.mla, cfg0.moe
    assert (cfg0.d_model, cfg0.n_heads, m.q_lora_rank, m.kv_lora_rank,
            m.qk_nope_dim, m.qk_rope_dim, m.v_dim, moe.n_experts, moe.top_k,
            moe.d_ff_expert, moe.n_shared, cfg0.vocab) == (
        5120, 128, 1536, 512, 128, 64, 128, 160, 6, 1536, 2, 102400)
    L = cfg0.n_layers
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {MLA_ARCH} depth {L}: {n_params} parameters "
          f"({4 * n_params / 1e9:.1f} GB float32) drawn in "
          f"{time.perf_counter() - t0:.1f}s")
    prompts = request_prompts(cfg0.vocab, SERVE["requests"],
                              SERVE["prompt_lens"])
    new = SERVE["new"]
    base = dict(max_cache=max(SERVE["prompt_lens"]) + new + 8,
                max_new_tokens=new, page_size=16,
                max_seqs=SERVE["max_seqs"])
    out, tokens = {}, {}

    def cfg_for(targets):
        return dataclasses.replace(cfg0, rns_targets=targets)

    # the kernels against the plain RNS path on the card: one prompt's
    # prefill logits, bit for bit
    tok = torch.as_tensor(prompts[2][None].astype(np.int64), device="cuda")
    cfg = cfg_for("all")
    model.cfg = cfg
    lg = M.prefill(model, cfg, tok, 128)[0]
    ref = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="reference"))
    lg_ref = M.prefill(model, ref, tok, 128)[0]
    if lg.shape != (1, cfg0.vocab) or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"prefill logits {tuple(lg.shape)} not finite")
    if not torch.equal(lg, lg_ref):
        raise AssertionError("prefill logits on the kernels differ from the "
                             "plain RNS path's: max "
                             f"{float((lg - lg_ref).abs().max())}")
    print("  serve_mla_all: a 120-token prefill's logits on the kernels "
          "bit-equal to the plain RNS path on the card")
    del lg, lg_ref

    for label, (key, targets, kw) in MLA_PATHS.items():
        per_dec, per_pre = ({k: v * L for k, v in ops.items()}
                            for ops in MLA_OPS[key])
        want_launch = {k: v * L for k, v in MLA_LAUNCHES[key].items()}
        chunked = kw.get("chunked_prefill", False)
        program = ("mixed" if chunked else
                   "verify" if kw.get("spec_decode") else "decode")
        numbers, runs = {}, {}
        for graphs in (False, True):
            model.cfg = cfg_for(targets)
            mode = "captured" if graphs else "eager"
            _reset_launches()
            log: list = []
            path_calls: dict = {}
            in_step: dict = {}
            t1 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if not graphs:
                    stack.enter_context(_recording(torch, path_calls, None,
                                                   in_step))
                stack.enter_context(_step_launches(log, in_step))
                engine = ContinuousEngine(model, ServeConfig(**base, **kw),
                                          device="cuda", graphs=graphs)
                results, stats = engine.run(prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            steps = stats["steps"]
            for s in steps:
                want = (per_dec if chunked else {
                    k: v + per_pre[k] * len(s["admitted"])
                    for k, v in per_dec.items()})
                if s["rns_ops"].as_dict() != want:
                    raise AssertionError((label, mode, s["step"],
                                          s["rns_ops"], want))
            want_caps = {program: int(graphs)}
            if not chunked:
                want_caps["prefill"] = int(graphs)
            if stats["captures"] != want_caps:
                raise AssertionError(f"{label} {mode}: captures "
                                     f"{stats['captures']}")
            runs[mode] = (_tokens(results),
                          [s["rns_ops"].as_dict() for s in steps])
            numbers[mode] = _serve_numbers(engine, stats, wall, None)
            if not graphs:
                launches[label] = run = _launches()
                stepped = [lc for st, lc in log if st["decoded"] and (
                    chunked or not st["admitted"])]
                if not stepped or any(lc != want_launch for lc in stepped):
                    raise AssertionError(f"{label}: {program} step launches "
                                         f"{stepped[:1]}, want {want_launch}")
                for k, n in run.items():
                    if (n > 0) != (want_launch[k] > 0):
                        raise AssertionError((label, k, n))
                _merge_calls(calls, path_calls)
                numbers["eager"]["launches"] = dict(run)
            else:
                replay = _replay_kernels(torch, engine, program)
                if replay["by_kernel"] != {k: n for k, n in
                                           want_launch.items() if n}:
                    raise AssertionError(f"{label}: a replayed {program} "
                                         f"step ran {replay['by_kernel']}")
                numbers["captured"]["replayed_step"] = {
                    k: replay[k] for k in ("by_kernel", "all_kernels",
                                           "device_ms")}
                _print_top(f"{label} {program}", replay)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        if runs["captured"] != runs["eager"]:
            raise AssertionError(f"{label}: captured tokens or rns_ops "
                                 "differ from the eager serve's")
        tokens[label] = runs["captured"][0]
        if label in ("serve_mla_chunked", "serve_mla_spec") and \
                tokens[label] != tokens["serve_mla"]:
            raise AssertionError(f"{label}: greedy tokens differ from the "
                                 "whole-prompt plain serve's")
        out[label] = numbers
        _print_numbers(label, numbers)
        if label == "serve_mla_chunked":
            # the bucketed Engine on 8 x 33 before the fused path encodes
            # the shared experts resident: tokens = ContinuousEngine's
            out["serve_mla_bucketed"] = _mla_bucketed(
                torch, model, cfg_for("mlp"), launches, calls)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    out["max_memory_allocated"] = peak
    print(f"  serve_mla max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    return out


def _mla_bucketed(torch, model, cfg, launches, calls):
    """The bucketed Engine (BUCKETED_SERVE) on ``model``, eager
    (recorded) then captured (``prefill(8,33)=1 decode(8)=1``, the same
    tokens, each decode step launching the path's kernels); greedy tokens
    equal to the captured ContinuousEngine's on the same prompts."""
    import gc

    import numpy as np

    from repro_torch.serve.engine import ContinuousEngine, Engine, ServeConfig

    B, T, new = (BUCKETED_SERVE[k] for k in ("batch", "prompt_len", "new"))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)
    names = (f"prefill({B},{T})", f"decode({B})")
    want_launch = {k: v * cfg.n_layers for k, v in MLA_LAUNCHES["mlp"].items()}
    label = "serve_mla_bucketed"
    numbers, toks = {}, {}
    model.cfg = cfg
    for graphs in (False, True):
        mode = "captured" if graphs else "eager"
        _reset_launches()
        log: list = []
        path_calls: dict = {}
        in_step: dict = {}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(_recording(torch, path_calls, None,
                                               in_step))
            stack.enter_context(_engine_runs(log, in_step))
            engine = Engine(model, ServeConfig(max_cache=T + new + 8,
                                               max_new_tokens=new),
                            device="cuda", graphs=graphs)
            toks[mode] = engine.generate(prompts).tolist()
            t_gen = time.perf_counter()
            engine.generate(prompts)
            warm = time.perf_counter() - t_gen
        torch.cuda.synchronize()
        caps = engine.captures()
        if caps != {n: int(graphs) for n in names}:
            raise AssertionError(f"{label} {mode}: captures {caps}")
        steps = [lc for prog, lc in log if prog == names[1]]
        if not graphs:
            launches[label] = _launches()
            if not steps or any(lc != want_launch for lc in steps):
                raise AssertionError(f"{label}: decode step launches "
                                     f"{steps[:1]}, want {want_launch}")
            _merge_calls(calls, path_calls)
        numbers[mode] = {
            "setup_and_run_s": time.perf_counter() - t0,
            "warm_tokens_per_s": B * new / warm,
            "ttft_s": engine.last_stats["ttft_s"],
            "decode_step_ms_median": 1e3 * statistics.median(
                engine.last_stats["step_time_s"]),
            "captures": caps}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if toks["captured"] != toks["eager"]:
        raise AssertionError(f"{label}: captured tokens differ from eager")
    res, cstats = ContinuousEngine(model, ServeConfig(
        max_cache=T + new + 8, max_new_tokens=new, page_size=16,
        max_seqs=B), device="cuda").run(list(prompts))
    if _tokens(res) != toks["captured"]:
        raise AssertionError(f"{label}: bucketed greedy tokens differ from "
                             "the ContinuousEngine's")
    numbers["continuous_captured_tokens_per_s"] = cstats["tokens_per_s"]
    gc.collect()
    torch.cuda.empty_cache()
    _print_numbers(label, numbers)
    print(f"  {label}: greedy tokens equal to the ContinuousEngine's")
    return numbers


# [serve_archs] and [serve_ssm]: the dense archs with the q/k/v bias,
# Llama-4-Scout, RWKV-6 and Jamba at their published widths
# (configs/all_archs.py).  Depth: tinyllama 11 of 22 (whole 4.1 GiB of
# float32 weights: cut when [dist] came, for the run's time), granite 10
# of 40 (whole 31.2 GiB: 20 when [train_archs] came, 10 when [dist]
# came); rwkv6 8 of 32 (whole 28.1 GiB; 16 when
# [serve_encdec] came, 8 when [train_archs] came); qwen2.5-32b 4 of 64
# (whole 122.1 GiB; 8 until [train_archs] came),
# Scout 2 of 48 (24.1 GiB), Jamba 8 of 32 (one period: 7 mamba + 1
# attention layer, 4 MoE; 49.5 GiB).
# label -> (arch, depth (None: all), rns_targets (None: float), engine,
# ServeConfig overrides).  An arch's cells share one model, drawn once,
# the fused cell last (it encodes the dense MLPs resident in place).
ARCH_DEPTH = {"qwen2.5-32b": 4, "llama4-scout-17b-a16e": 2,
              "jamba-v0.1-52b": 8, "rwkv6-7b": 8, "whisper-medium": 2,
              "granite-3-8b": 10, "paligemma-3b": 4, "tinyllama-1.1b": 11}
# >= E / k: dropless, so chunked and bucketed tokens can equal
# whole-prompt ones (the published 1.25 drops tokens a prompt's chunks
# keep)
ARCH_CAPACITY = {"llama4-scout-17b-a16e": 16.0, "jamba-v0.1-52b": 8.0}
ARCH_CELLS = {
    "serve_archs_tinyllama": ("tinyllama-1.1b", "mlp", "continuous", {}),
    "serve_archs_granite": ("granite-3-8b", "mlp", "continuous", {}),
    "serve_archs_granite_bucketed": ("granite-3-8b", "mlp", "bucketed", {}),
    "serve_archs_qwen": ("qwen2.5-32b", "mlp", "continuous", {}),
    "serve_archs_qwen_bucketed": ("qwen2.5-32b", "mlp", "bucketed", {}),
    "serve_archs_qwen_all": ("qwen2.5-32b", "all", "continuous", {}),
    "serve_archs_qwen_chunked": ("qwen2.5-32b", "mlp", "continuous",
                                 CHUNKED_SERVE),
    "serve_archs_qwen_fused": ("qwen2.5-32b", "mlp", "continuous",
                               FUSED_SERVE),
    "serve_archs_scout": ("llama4-scout-17b-a16e", "mlp", "continuous", {}),
    "serve_archs_scout_bucketed": ("llama4-scout-17b-a16e", "mlp",
                                   "bucketed", {}),
    "serve_archs_scout_fused": ("llama4-scout-17b-a16e", "mlp", "continuous",
                                FUSED_SERVE),
}
SSM_CELLS = {
    "serve_ssm_rwkv_float": ("rwkv6-7b", None, "bucketed", {}),
    "serve_ssm_rwkv": ("rwkv6-7b", "mlp", "bucketed", {}),
    "serve_ssm_jamba_float": ("jamba-v0.1-52b", None, "bucketed", {}),
    "serve_ssm_jamba": ("jamba-v0.1-52b", "mlp", "bucketed", {}),
    "serve_ssm_jamba_fused": ("jamba-v0.1-52b", "mlp", "bucketed",
                              FUSED_SERVE),
}
# rows of the 8 x 33 batch served again alone (batch invariance)
SOLO_ROWS = (0, 5)
# whisper-medium (2 + 2 of its 24 + 24 layers over 1500 frames: 12 + 12
# when [train] came, 2 + 2 when [train_archs] came, for the run's time)
# and paligemma-3b (4 of its 18 layers behind 256 patch embeddings; whole
# until [train_archs] came) at full
# width, through the bucketed Engine on 8 x 33 prompts with their frames
# (seed 0); the fused cell of an arch last (it encodes the MLPs resident
# in place)
ENCDEC_CELLS = {
    "serve_encdec_whisper_float": ("whisper-medium", None, "bucketed", {}),
    "serve_encdec_whisper": ("whisper-medium", "mlp", "bucketed", {}),
    "serve_encdec_whisper_fused": ("whisper-medium", "mlp", "bucketed",
                                   FUSED_SERVE),
    "serve_encdec_paligemma": ("paligemma-3b", "mlp", "bucketed", {}),
    "serve_encdec_paligemma_all": ("paligemma-3b", "all", "bucketed", {}),
    "serve_encdec_paligemma_fused": ("paligemma-3b", "mlp", "bucketed",
                                     FUSED_SERVE),
}


def _arch_model(arch: str):
    """``arch`` at its published width, depth ARCH_DEPTH (else all; an
    encoder-decoder's encoder cut alike), MoE
    dropless (ARCH_CAPACITY), rns9 (qx = qw = 8) on the MLPs and the
    recurrent layers' projections, random weights from seed 0 drawn on
    the card.  Returns (model, the changes to the published config)."""
    from repro_torch.configs.base import at_depth, get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.models.model import init_model

    full = get_config(arch)
    cfg, changed = full, {}
    if arch in ARCH_DEPTH:
        cfg = at_depth(cfg, ARCH_DEPTH[arch])
        changed["n_layers"] = f"{full.n_layers} -> {cfg.n_layers}"
        if cfg.enc_dec:             # the encoder stack too
            cfg = dataclasses.replace(cfg, n_enc_layers=ARCH_DEPTH[arch])
            changed["n_enc_layers"] = (f"{full.n_enc_layers} -> "
                                       f"{cfg.n_enc_layers}")
    if arch in ARCH_CAPACITY:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=ARCH_CAPACITY[arch]))
        changed["capacity_factor"] = (f"{full.moe.capacity_factor} -> "
                                      f"{ARCH_CAPACITY[arch]} (dropless)")
    cfg = dataclasses.replace(cfg, rns=RnsDotConfig(profile="rns9", qx=8,
                                                    qw=8))
    return init_model(cfg, seed=0, device="cuda"), changed


def _launch_ops_agree(ops: dict, lc: dict) -> bool:
    """One step's kernel launches against its RNS op tallies: every
    rns_matmul / rns_normalize launch and every fused kernel is one
    ``matmuls`` / ``normalizes`` (the fused dot and matmul + normalize
    count both) and one ``fused``; a convert launch or a fused encode is
    one ``converts`` (a fused dot over a shared conversion counts
    none)."""
    fused = (lc["rns_fused_encode_matmul"] + lc["rns_fused_matmul_normalize"]
             + lc["rns_fused_dot"])
    return (ops["fused"] == fused
            and ops["matmuls"] == lc["rns_matmul"] + fused
            and ops["normalizes"] == lc["rns_normalize"]
            + lc["rns_fused_matmul_normalize"] + lc["rns_fused_dot"]
            and lc["rns_convert"] + lc["rns_fused_encode_matmul"]
            <= ops["converts"] <= lc["rns_convert"] + fused)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _continuous_cell(torch, model, label, kw, launches, record, seen):
    """The [serve] traffic through ContinuousEngine on ``model`` (its
    cfg set by the caller), eager (counts from 0, every distinct wrapper
    call recorded and checked against its plain version, each decode or
    mixed step's launches equal and agreeing with its rns_ops) then
    captured (one capture a program, the eager tokens and rns_ops, a
    replayed step's kernel nodes the eager step's launches).  Returns
    (numbers, tokens)."""
    import gc

    from repro_torch.launch.serve import request_prompts
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    prompts = request_prompts(model.cfg.vocab, SERVE["requests"],
                              SERVE["prompt_lens"])
    new = SERVE["new"]
    chunked = kw.get("chunked_prefill", False)
    program = "mixed" if chunked else "decode"
    numbers, runs, step_lc = {}, {}, None
    for graphs in (False, True):
        mode = "captured" if graphs else "eager"
        _reset_launches()
        log: list = []
        path_calls: dict = {}
        in_step: dict = {}
        t1 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if not graphs:
                stack.enter_context(_recording(torch, path_calls, None,
                                               in_step))
            stack.enter_context(_step_launches(log, in_step))
            engine = ContinuousEngine(model, ServeConfig(
                max_cache=max(SERVE["prompt_lens"]) + new + 8,
                max_new_tokens=new, page_size=16,
                max_seqs=SERVE["max_seqs"], **kw), device="cuda",
                graphs=graphs)
            results, stats = engine.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        want_caps = {program: int(graphs)}
        if not chunked:
            want_caps["prefill"] = int(graphs)
        if stats["captures"] != want_caps:
            raise AssertionError(f"{label} {mode}: captures "
                                 f"{stats['captures']}")
        steps = stats["steps"]
        runs[mode] = (_tokens(results),
                      [s["rns_ops"].as_dict() for s in steps])
        numbers[mode] = _serve_numbers(engine, stats, wall, None)
        if not graphs:
            launches[label] = dict(_launches())
            stepped = [(st, lc) for st, lc in log if st["decoded"] and (
                chunked or not st["admitted"])]
            if not stepped:
                raise AssertionError(f"{label}: no {program} step")
            step_lc = stepped[0][1]
            for st, lc in stepped:
                if lc != step_lc or not _launch_ops_agree(
                        st["rns_ops"].as_dict(), lc):
                    raise AssertionError(f"{label}: {program} step "
                                         f"launches {lc}, rns_ops "
                                         f"{st['rns_ops']}")
            numbers["eager"]["rns_kernels_per_decode_step"] = sum(
                step_lc.values())
            numbers["eager"]["launches"] = launches[label]
        else:
            replay = _replay_kernels(torch, engine, program)
            if replay["by_kernel"] != {k: n for k, n in step_lc.items()
                                       if n}:
                raise AssertionError(f"{label}: a replayed {program} step "
                                     f"ran {replay['by_kernel']}, the eager "
                                     f"step {step_lc}")
            numbers["captured"]["rns_kernels_per_decode_step"] = \
                replay["rns_kernels"]
            numbers["captured"]["replayed_step"] = {
                k: replay[k] for k in ("by_kernel", "all_kernels",
                                       "device_ms")}
            _print_top(f"{label} {program}", replay)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if not graphs:
            phase_kernels(torch, torch.device("cuda"), record, path_calls,
                          launches, main_path_only=True, seen=seen,
                          tag=f"{label}: ")
            del path_calls
    if runs["captured"] != runs["eager"]:
        raise AssertionError(f"{label}: captured tokens or rns_ops differ "
                             "from the eager serve's")
    return numbers, runs["captured"][0]


def _bucketed_cell(torch, model, label, kw, launches, record, seen, *,
                   solo=()):
    """The bucketed Engine on BUCKETED_SERVE's 8 x 33 prompts (with a
    model's frontend frames), eager (recorded and checked as in
    :func:`_continuous_cell`) then captured (``prefill(8,33)=1
    decode(8)=1``, the eager tokens, a replayed decode step's kernel
    nodes the eager step's launches), each one generate after its
    programs are built; the rows ``solo`` served alone (B = 1) on the
    captured engine: their tokens and final state planes bit-equal to
    the batch's.  Returns (numbers, tokens, prompts)."""
    import gc

    import numpy as np

    from repro_torch.models.model import STATE_PLANES
    from repro_torch.serve.engine import Engine, ServeConfig

    from repro_torch.data.pipeline import make_frontend_stub

    B, T, new = (BUCKETED_SERVE[k] for k in ("batch", "prompt_len", "new"))
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    # a frontend's frames: drawn after the prompts from the same
    # generator, as the CLI draws them; a prefix model's rows hold them
    frames, F = None, 0
    if cfg.frontend is not None:
        frames = make_frontend_stub(rng, B, cfg.n_frontend_tokens,
                                    cfg.d_model)
        F = 0 if cfg.enc_dec else cfg.n_frontend_tokens
    names = (f"prefill({B},{T})", f"decode({B})")
    rns = cfg.rns is not None
    numbers, toks, step_lc = {}, {}, None
    for graphs in (False, True):
        mode = "captured" if graphs else "eager"
        _reset_launches()
        log: list = []
        path_calls: dict = {}
        in_step: dict = {}
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if not graphs and rns:
                stack.enter_context(_recording(torch, path_calls, None,
                                               in_step))
            stack.enter_context(_engine_runs(log, in_step))
            engine = Engine(model, ServeConfig(max_cache=F + T + new + 8,
                                               max_new_tokens=new, **kw),
                            device="cuda", graphs=graphs)
            # the programs built (warmed; captured) first, so one warm
            # generate gives both the tokens and the numbers
            engine._bucket(B, T)
            t_gen = time.perf_counter()
            toks[mode] = engine.generate(prompts, frontend=frames).tolist()
            torch.cuda.synchronize()
            warm = time.perf_counter() - t_gen
        caps = engine.captures()
        if caps != {n: int(graphs) for n in names}:
            raise AssertionError(f"{label} {mode}: captures {caps}")
        numbers[mode] = {
            "setup_and_run_s": time.perf_counter() - t0,
            "tokens_per_s": B * new / warm,
            "ttft_p50_s": engine.last_stats["ttft_s"],
            "decode_step_ms_median": 1e3 * statistics.median(
                engine.last_stats["step_time_s"]),
            "captures": caps}
        ops = engine.programs[names[1]].ops.as_dict()
        if not graphs:
            launches[label] = dict(_launches())
            steps = [lc for prog, lc in log if prog == names[1]]
            step_lc = steps[0]
            if any(lc != step_lc for lc in steps) or not _launch_ops_agree(
                    ops, step_lc) or (rns and not any(step_lc.values())):
                raise AssertionError(f"{label}: decode step launches "
                                     f"{steps[:2]}, rns_ops {ops}")
            numbers["eager"]["rns_kernels_per_decode_step"] = sum(
                step_lc.values())
        else:
            if solo:
                batch = {n: getattr(engine._caches[B], n).clone()
                         for n in STATE_PLANES
                         if getattr(engine._caches[B], n) is not None}
                for b in solo:
                    one = engine.generate(
                        prompts[b:b + 1], frontend=None if frames is None
                        else frames[b:b + 1]).tolist()[0]
                    if one != toks[mode][b]:
                        raise AssertionError(f"{label}: row {b} alone gave "
                                             "other tokens than in the "
                                             "batch")
                    for n, planes in batch.items():
                        alone = getattr(engine._caches[1], n)
                        if not torch.equal(alone[:, 0], planes[:, b]):
                            raise AssertionError(
                                f"{label}: row {b}'s final {n} alone "
                                "differs from the batch's")
                numbers["solo_rows_equal"] = list(solo)
            replay = _replay_kernels(torch, engine, names[1])
            if replay["by_kernel"] != {k: n for k, n in step_lc.items()
                                       if n}:
                raise AssertionError(f"{label}: a replayed decode step ran "
                                     f"{replay['by_kernel']}, the eager "
                                     f"step {step_lc}")
            numbers["captured"]["rns_kernels_per_decode_step"] = \
                replay["rns_kernels"]
            numbers["captured"]["replayed_step"] = {
                k: replay[k] for k in ("by_kernel", "all_kernels",
                                       "device_ms")}
            _print_top(f"{label} {names[1]}", replay)
        numbers[mode]["rns_ops_per_decode_step"] = ops
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if path_calls:
            phase_kernels(torch, torch.device("cuda"), record, path_calls,
                          launches, main_path_only=True, seen=seen,
                          tag=f"{label}: ")
            del path_calls
    if toks["captured"] != toks["eager"]:
        raise AssertionError(f"{label}: captured tokens differ from eager")
    return numbers, toks["captured"], prompts


def _serve_cells(torch, cells, launches, record, *, solo=()):
    """Serve each cell of ``cells`` (an arch's cells together, its model
    drawn once and freed before the next arch's), printing each cell's
    numbers with the card's name and power limit and each model's peak
    device memory.  Returns ({label: numbers}, {label: tokens})."""
    import gc

    smi = _smi()
    out, tokens, seen = {}, {}, set()
    by_arch: dict = {}
    for label, cell in cells.items():
        by_arch.setdefault(cell[0], []).append((label, cell))
    for arch, group in by_arch.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, changed = _arch_model(arch)
        torch.cuda.synchronize()
        cfg0 = model.cfg
        n_params = sum(p.numel() for p in model.parameters())
        print(f"  {arch}: d_model {cfg0.d_model}, depth {cfg0.n_layers}, "
              f"{n_params} parameters ({4 * n_params / 2**30:.1f} GiB "
              f"float32) drawn in {time.perf_counter() - t0:.1f}s; "
              f"changed from the published config: {changed or 'nothing'}")
        for label, (_, targets, engine, kw) in group:
            model.cfg = (dataclasses.replace(cfg0, rns=None)
                         if targets is None else
                         dataclasses.replace(cfg0, rns_targets=targets))
            if engine == "continuous":
                numbers, toks = _continuous_cell(torch, model, label, kw,
                                                 launches, record, seen)
            else:
                numbers, toks, _ = _bucketed_cell(
                    torch, model, label, kw, launches, record, seen,
                    solo=solo)
            numbers["changed"] = changed
            out[label], tokens[label] = numbers, toks
            _print_numbers(label, numbers)
            print(f"  {label}: on {smi}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
        out[f"{arch} max_memory_allocated"] = peak
        print(f"  {arch} max_memory_allocated {peak} bytes "
              f"({peak / 2**30:.2f} GiB) on {smi}")
    return out, tokens


def phase_serve_archs(torch, launches, record):
    """tinyllama-1.1b (depth 11), granite-3-8b (depth 10), qwen2.5-32b
    (depth 4, q/k/v bias) and Llama-4-Scout (depth 2, dropless) at their
    published widths through the engines (ARCH_CELLS): eager then
    captured, every distinct kernel input checked against its plain
    version while the model is on the card; qwen's chunked tokens equal
    its whole-prompt ones, Scout's bucketed tokens its
    ContinuousEngine's."""
    out, tokens = _serve_cells(torch, ARCH_CELLS, launches, record)
    if tokens["serve_archs_qwen_chunked"] != tokens["serve_archs_qwen"]:
        raise AssertionError("qwen2.5-32b: chunked greedy tokens differ "
                             "from the whole-prompt serve's")
    # the bucketed 8 x 33 rows against ContinuousEngine on the same
    # prompts: served on a fresh draw of the same model
    import gc

    import numpy as np

    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    model, _ = _arch_model("llama4-scout-17b-a16e")
    B, T, new = (BUCKETED_SERVE[k] for k in ("batch", "prompt_len", "new"))
    prompts = np.random.default_rng(0).integers(
        0, model.cfg.vocab, (B, T)).astype(np.int32)
    res, _ = ContinuousEngine(model, ServeConfig(
        max_cache=T + new + 8, max_new_tokens=new, page_size=16,
        max_seqs=B), device="cuda").run(list(prompts))
    if _tokens(res) != tokens["serve_archs_scout_bucketed"]:
        raise AssertionError("llama4-scout: bucketed greedy tokens differ "
                             "from the ContinuousEngine's")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print("  serve_archs: qwen chunked = whole-prompt tokens; Scout "
          "bucketed = ContinuousEngine tokens")
    return out


def phase_serve_ssm(torch, launches, record):
    """rwkv6-7b (depth 8) and jamba-v0.1-52b (depth 8, dropless) at their
    published widths through the bucketed Engine (SSM_CELLS: float,
    per-op rns9, and fused for Jamba), eager then captured; rows
    SOLO_ROWS of the 8 x 33 batch served alone give the same tokens and
    bit-equal final state planes; ContinuousEngine refuses both archs
    with the JAX engine's message."""
    from repro_torch.configs.base import at_depth, get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    for arch in ("rwkv6-7b", "jamba-v0.1-52b"):
        cfg = at_depth(get_config(arch), 8)
        try:
            ContinuousEngine(Model(cfg, device="meta"), ServeConfig(),
                             device="meta")
        except NotImplementedError as e:
            if not str(e).startswith("continuous batching pages attn/mla "
                                     f"caches only; {arch} has layer "
                                     "types"):
                raise
            print(f"  {arch}: ContinuousEngine refuses: {e}")
        else:
            raise AssertionError(f"{arch}: ContinuousEngine did not refuse")
    out, _ = _serve_cells(torch, SSM_CELLS, launches, record,
                          solo=SOLO_ROWS)
    return out


def phase_serve_encdec(torch, launches, record):
    """whisper-medium and paligemma-3b at their published widths (depths
    ARCH_DEPTH) through the bucketed Engine (ENCDEC_CELLS: whisper float,
    per-op rns9 and fused; paligemma per-op, ``rns_targets="all"`` and
    fused), each prompt with its frontend's frames, eager then captured
    (the same tokens and rns_ops, one capture a program, a replayed
    decode step's kernel nodes the eager step's launches, every distinct
    kernel input checked against its plain version while the model is on
    the card); rows SOLO_ROWS served alone give the batch's tokens;
    ContinuousEngine refuses both archs with the JAX engine's message."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig

    want = "continuous batching is decoder-only (no enc-dec / frontend)"
    for arch in ("whisper-medium", "paligemma-3b"):
        try:
            ContinuousEngine(Model(get_config(arch), device="meta"),
                             ServeConfig(), device="meta")
        except NotImplementedError as e:
            if str(e) != want:
                raise
            print(f"  {arch}: ContinuousEngine refuses: {e}")
        else:
            raise AssertionError(f"{arch}: ContinuousEngine did not refuse")
    out, _ = _serve_cells(torch, ENCDEC_CELLS, launches, record,
                          solo=SOLO_ROWS)
    return out


def phase_kernels(torch, dev, record, calls, launches, *,
                  main_path_only=False, seen=None, tag=""):
    """The six RNS kernels bit for bit on the inputs the serves gave
    them, at every candidate tiling and on boundary cases; flash_attention
    within tolerance on ragged and full-width shapes; times of the
    main-path inputs and of flash at full width.  Fills ``record``.

    ``main_path_only``: just the serves' own inputs (each checked and
    timed, its eager time not taken), skipping the calls whose keys are in
    the set ``seen`` and adding the others to it -- what [serve_archs] and
    [serve_ssm] run on each cell's calls while its model is on the card;
    the launch counts are left as they are.  ``tag`` heads each case's
    label (the cell that gave the input)."""
    import torch.nn.functional as F

    from repro_torch.analysis.kernel_audit import fused_ring
    from repro_torch.core.moduli import PROFILES, get_profile
    from repro_torch.core.rns import encode_exact
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_attention import ops as fa_ops

    if not calls:
        raise AssertionError("no main-path calls recorded: the serves did "
                             "not run, so there are no main-path inputs")
    if not main_path_only:
        _reset_launches()
    g = torch.Generator(device=dev).manual_seed(0)
    mods = _kernel_mods()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bad = []

    def case(kernel, label, fn, plain, nbytes=0, ops=0, rate=1, timed=True,
             library=None, calls_in_serve=None, check=None, note=None,
             unfused=None):
        """``check(got, want) -> (ok, extra)``; by default bit-equal.
        ``note`` says which rate ``rate`` is, for the bound; ``unfused =
        (fn, note)`` is the port's unfused chain on the same inputs, held
        to the plain version too and timed as ``unfused_ms``."""
        got, want = fn(), plain()
        err = _max_abs_err(torch, got, want)
        entry = {"case": label, "max_abs_err": err}
        ok = err == 0
        if check is not None:
            ok, extra = check(got, want)
            entry.update(extra)
        if calls_in_serve is not None:
            entry["calls_in_serve"] = calls_in_serve
        if timed:
            b, by = _bound(nbytes, ops, rate)
            entry.update(ms=_time_ms(torch, fn, 20),
                         plain_ms=_time_ms(torch, plain, 5),
                         bound_ms=b, bound_by=by, library_ms=None)
            if not main_path_only:
                entry["eager_ms"] = _eager_ms(torch, fn, 50)
            if note is not None:
                entry["bound_note"] = note
            if library is not None:
                entry["library_ms"], entry["library_note"] = library()
            if unfused is not None:
                chain, entry["unfused_note"] = unfused
                chain_err = _max_abs_err(torch, chain(), want)
                entry["unfused_max_abs_err"] = chain_err
                ok = ok and chain_err == 0
                entry["unfused_ms"] = _time_ms(torch, chain, 20)
        record.setdefault(kernel, []).append(entry)
        if not ok:
            bad.append(f"{kernel} {label}: " + " ".join(
                f"{k}={v}" for k, v in entry.items() if k != "case"))
        print(f"  {kernel:26s} {label:52s} " + " ".join(
            f"{k}={v}" for k, v in entry.items() if k != "case"))

    def int_mm(a, b):
        """Per-digit torch._int_mm over [K, M, D] @ [K, D, N] (no mod);
        ``a`` zero-padded to 32 rows where it has 16 or fewer, which
        _int_mm refuses."""
        note = "per-digit torch._int_mm (no mod), one call per digit"
        if a.shape[1] <= 16:
            pad = torch.zeros((a.shape[0], 32, a.shape[2]), dtype=a.dtype,
                              device=a.device)
            pad[:, :a.shape[1]] = a
            a = pad
            note += ", a zero-padded to 32 rows (_int_mm needs > 16)"

        def run():
            return [torch._int_mm(a[s], b[s]) for s in range(a.shape[0])]

        def timed():
            try:
                run()
            except RuntimeError as e:
                return None, f"torch._int_mm refuses this shape: {e}"[:160]
            return _time_ms(torch, run, 5), note
        return timed

    def unfused_chain(kernel, prof, args, kw):
        """The port's unfused kernels on a fused kernel's inputs, in the
        order the per-op path runs them."""
        p = get_profile(prof)
        c_ops, m_ops, n_ops = (mods[k] for k in (
            "rns_convert", "rns_matmul", "rns_normalize"))
        rd = torch.int8 if p.int8_safe else torch.int32
        if kernel == "rns_fused_matmul_normalize":
            a, b = args
            a8 = a.to(rd)           # the per-op path's residues are int8

            def chain():
                return n_ops.rns_normalize(p, m_ops.rns_matmul(p, a8, b))
            return chain, ("rns_matmul -> rns_normalize in one graph, "
                           f"a_res cast to {rd} outside it")
        x, sc, b = args

        def chain():
            res = m_ops.rns_matmul(p, c_ops.rns_convert(
                p, x, sc, bits=kw.get("bits", 16), out_dtype=rd), b)
            return res if kernel == "rns_fused_encode_matmul" else \
                n_ops.rns_normalize(p, res)
        return chain, "rns_convert -> rns_matmul" + (
            "" if kernel == "rns_fused_encode_matmul"
            else " -> rns_normalize") + " in one graph"

    # ---- the main paths' own inputs: every distinct call of the serves
    for key, entry in sorted(calls.items(),
                             key=lambda e: (e[1]["kernel"], -e[1]["calls"])):
        if seen is not None:
            if key in seen:
                continue
            seen.add(key)
        kernel, prof, args, kw = (entry["kernel"], entry["profile"],
                                  entry["args"], entry["kw"])
        K = get_profile(prof).n_digits
        label, nbytes, ops, rate = _cost(torch, kernel, K, args, kw)
        label = f"{tag}{get_profile(prof).name} {label}"
        library = None
        if kernel == "rns_matmul":
            a, b = args
            library = int_mm(a.reshape(K, -1, b.shape[1]), b)
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        case(kernel, label,
             lambda w=wrapper: w(prof, *args, **kw),
             lambda f=plain: f(prof, *args, **kw),
             nbytes, ops, rate, library=library,
             calls_in_serve=entry["calls"],
             unfused=(unfused_chain(kernel, prof, args, kw)
                      if kernel.startswith("rns_fused") else None))

    if main_path_only:
        torch.cuda.synchronize()
        if bad:
            raise AssertionError("kernels disagree with their plain "
                                 "versions:\n" + "\n".join(bad))
        return
    # ---- every candidate tiling, on each kernel's most called input
    heads = {}
    for entry in sorted(calls.values(), key=lambda e: -e["calls"]):
        heads.setdefault(entry["kernel"], entry)
    for kernel, entry in sorted(heads.items()):
        prof, args, kw = entry["profile"], entry["args"], entry["kw"]
        label = get_profile(prof).name + " " + _cost(
            torch, kernel, get_profile(prof).n_digits, args, kw)[0]
        mod = mods[kernel]
        wrapper, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        want = plain(prof, *args, **kw)
        for cand in autotune.CANDIDATES[kernel]:
            case(kernel, f"{label} tile {_blk(cand)}",
                 lambda w=wrapper, c=cand: w(prof, *args, **kw, **c),
                 lambda: want, timed=False)

    # ---- the fused encode + matmul on every main-path input, at every
    # compiled tile with its split over D forced
    f_ops = mods["rns_fused_encode_matmul"]
    rule = f_ops.splits_for
    try:
        for entry in calls.values():
            if entry["kernel"] != "rns_fused_encode_matmul":
                continue
            prof, args, kw = entry["profile"], entry["args"], entry["kw"]
            label = _cost(torch, entry["kernel"],
                          get_profile(prof).n_digits, args, kw)[0]
            want = f_ops.rns_fused_encode_matmul_plain(prof, *args, **kw)
            for cand in autotune.CANDIDATES["rns_fused_encode_matmul"]:
                for n in (1, 2, 4):
                    f_ops.splits_for = lambda *_, n=n: n
                    case("rns_fused_encode_matmul",
                         f"{label} tile {_blk(cand)} split {n} (forced)",
                         lambda c=cand: f_ops.rns_fused_encode_matmul(
                             prof, *args, **kw, **c),
                         lambda: want, timed=False)
    finally:
        f_ops.splits_for = rule

    # ---- flash_attention: ragged shapes (untimed), full width (timed)
    def flash_check(got, want):
        ok, _ = fa_ops.within_tolerance(got, want)
        return ok, {"bar": f"{fa_ops.ATOL}" + (
            "" if got.dtype == torch.float32 else " + one step of bfloat16")}

    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for i, shape in enumerate(FLASH_RAGGED + FLASH_FULL):
                B, Tq, Tk, H, Hk, D = shape
                q, k, v = _flash_inputs(torch, dev, shape, dtype, 100 + i)
                esize = q.element_size()
                nbytes = esize * (2 * B * Tq * H * D + 2 * B * Tk * Hk * D)
                flops = 4 * B * H * Tq * Tk * D / (2 if causal else 1)
                if dtype == torch.float32:
                    # the faster of the CUDA cores and 3xTF32 (three TF32
                    # products per product) on the tensor cores
                    rate = max(F32_OPS_PER_S, TF32_OPS_PER_S / 3)
                    note = ("3 x ops / 495 TFLOP/s (3xTF32)"
                            if rate > F32_OPS_PER_S
                            else "ops / 67 TFLOP/s (float32)")
                else:
                    rate, note = BF16_OPS_PER_S, "ops / 989 TFLOP/s (bf16)"

                def sdpa(q=q, k=k, v=v, causal=causal):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=causal,
                        enable_gqa=True).transpose(1, 2)

                full = shape in FLASH_FULL
                case("flash_attention",
                     f"{str(dtype)[6:]} causal={causal} q[{B},{Tq},{H},{D}] "
                     f"kv[{B},{Tk},{Hk},{D}]",
                     lambda q=q, k=k, v=v, c=causal: fa_ops.flash_attention(
                         q, k, v, causal=c),
                     lambda q=q, k=k, v=v, c=causal:
                     fa_ops.flash_attention_plain(q, k, v, causal=c),
                     nbytes, flops, rate, timed=full, check=flash_check,
                     note=note,
                     library=(lambda f=sdpa: (
                         _time_ms(torch, f, 5),
                         "torch scaled_dot_product_attention, enable_gqa"))
                     if full else None)
                # every candidate tile the checker allows at this shape
                want = fa_ops.flash_attention_plain(q, k, v, causal=causal)
                legal, _ = autotune.legal_candidates(
                    "flash_attention", str(dtype)[6:], (Tq, Tk, D))
                for cand in legal:
                    case("flash_attention",
                         f"{str(dtype)[6:]} causal={causal} q[{B},{Tq},{H},"
                         f"{D}] tile {_blk(cand)}",
                         lambda q=q, k=k, v=v, c=causal, b=cand:
                         fa_ops.flash_attention(q, k, v, causal=c, **b),
                         lambda w=want: w, timed=False, check=flash_check)

    # ---- boundary cases: every profile, odd shapes, ROADMAP C.1
    c_ops, m_ops, n_ops, f_ops = (mods[k] for k in (
        "rns_convert", "rns_matmul", "rns_normalize", "rns_fused_dot"))
    for name in sorted(PROFILES):
        p = get_profile(name)
        x = 50 * torch.randn((4, 3, 96), generator=g, device=dev)
        x.view(-1)[:4] = torch.tensor([0.25, -0.25, 0.75, -63.75])  # k+0.5
        s = torch.tensor(2.0, device=dev)
        od = torch.int8 if p.int8_safe else torch.int32
        case("rns_convert", f"{name} half-way/clip [4,3,96]",
             lambda: c_ops.rns_convert(p, x, s, bits=8, out_dtype=od),
             lambda: c_ops.rns_convert_plain(p, x, s, bits=8, out_dtype=od),
             timed=False)
    for name in sorted(PROFILES):       # rns8_u8: int32 residues to 255
        p = get_profile(name)
        rd = torch.int8 if p.int8_safe else torch.int32
        # ragged rows and columns; D = 1100 is 9 K steps, shared among
        # blocks (splits_for) since K x 2 column tiles leave SMs idle
        a = _residues(torch, p, (37, 1100), g, dev).to(rd)
        b = _residues(torch, p, (1100, 70), g, dev).to(rd)
        want = m_ops.rns_matmul_plain(p, a, b)
        for cand in autotune.CANDIDATES["rns_matmul"]:
            case("rns_matmul", f"{name} [K,37,1100]{rd}@[K,1100,70] tile "
                 f"{_blk(cand)}",
                 lambda c=cand: m_ops.rns_matmul(p, a, b, **c),
                 lambda: want, timed=False)
    c1 = torch.as_tensor(encode_exact("rns5", [4_503_599_542_737_792,
                                               -4_503_599_542_737_792]),
                         device=dev)
    c1_want = torch.tensor([13505986560.0, -13505986560.0], device=dev)
    case("rns_normalize", "rns5 ROADMAP C.1",
         lambda: n_ops.rns_normalize("rns5", c1), lambda: c1_want,
         timed=False)
    one = torch.as_tensor(encode_exact("rns5", [[1]]).astype("int8"),
                          device=dev)
    case("rns_fused_matmul_normalize", "rns5 ROADMAP C.1",
         lambda: f_ops.rns_fused_matmul_normalize(
             "rns5", c1.reshape(-1, 2, 1), one).reshape(-1),
         lambda: c1_want, timed=False)
    for name in sorted(PROFILES):
        p = get_profile(name)
        r = _residues(torch, p, (4096,), g, dev)
        case("rns_normalize", f"{name} uniform [K,4096]",
             lambda: n_ops.rns_normalize(p, r),
             lambda: n_ops.rns_normalize_plain(p, r), timed=False)
        # B.3's edge values (0, 1, M/2 - 1, M/2, M/2 + 1, M - 1) at both
        # ends, T % 4 == 1, 2, 3 (a partial last block; planes off a
        # 16-byte boundary) and a contiguous view one int32 past one;
        # every candidate bt on the ragged, misaligned one
        edge = torch.as_tensor(encode_exact(name, [
            0, 1, p.M // 2 - 1, p.M // 2, p.M // 2 + 1, p.M - 1]),
            device=dev)
        for T in (4096, 4097, 4098, 4099):
            for off in (0, 1):
                buf = torch.zeros(p.n_digits * T + 1, dtype=torch.int32,
                                  device=dev)
                rr = buf[off:off + p.n_digits * T].view(p.n_digits, T)
                rr.copy_(_residues(torch, p, (T,), g, dev))
                rr[:, :6], rr[:, T - 6:] = edge, edge
                tiles = autotune.legal_candidates(
                    "rns_normalize", p, (T,))[0] if (T, off) == (4099, 1) \
                    else [{}]
                for cand in tiles:
                    case("rns_normalize",
                         f"{name} edges [K,{T}] +{off} int32"
                         + (f" tile {_blk(cand)}" if cand else ""),
                         lambda rr=rr, c=cand: n_ops.rns_normalize(p, rr,
                                                                   **c),
                         lambda rr=rr: n_ops.rns_normalize_plain(p, rr),
                         timed=False)
        # the fused kernels at ragged M, D, N, row scales, both a dtypes
        x = torch.randn((13, 130), generator=g, device=dev)
        s = 127.0 / x.abs().amax(dim=1, keepdim=True)
        bd = torch.int8 if p.int8_safe else torch.int32
        b = _residues(torch, p, (130, 37), g, dev).to(bd)
        for kernel in ("rns_fused_dot", "rns_fused_encode_matmul"):
            case(kernel, f"{name} x[13,130] rows @[K,130,37]",
                 lambda k=kernel: getattr(f_ops, k)(p, x, s, b, bits=8),
                 lambda k=kernel: getattr(f_ops, k + "_plain")(p, x, s, b,
                                                               bits=8),
                 timed=False)
        a_dtypes = (torch.int8, torch.int32) if p.int8_safe \
            else (torch.int32,)
        for ad in a_dtypes:
            a = _residues(torch, p, (13, 37), g, dev).to(ad)
            b2 = _residues(torch, p, (37, 21), g, dev).to(bd)
            case("rns_fused_matmul_normalize",
                 f"{name} [K,13,37]{ad}@[K,37,21]",
                 lambda: f_ops.rns_fused_matmul_normalize(p, a, b2),
                 lambda: f_ops.rns_fused_matmul_normalize_plain(p, a, b2),
                 timed=False)
        # D = 1100 over one row tile and 2-3 column tiles: the tensor-core
        # fused kernels share each tile's K steps among blocks, at every
        # candidate tile the checker allows
        x = torch.randn((13, 1100), generator=g, device=dev)
        s = 127.0 / x.abs().amax(dim=1, keepdim=True)
        b = _residues(torch, p, (1100, 70), g, dev).to(bd)
        split_in = [(k, "x[13,1100] rows @[K,1100,70]", (x, s, b),
                     {"bits": 8}) for k in ("rns_fused_dot",
                                            "rns_fused_encode_matmul")]
        split_in += [("rns_fused_matmul_normalize",
                      f"[K,13,1100]{ad}@[K,1100,70]",
                      (_residues(torch, p, (13, 1100), g, dev).to(ad), b),
                      {}) for ad in a_dtypes]
        for kernel, label, args, kw in split_in:
            want = getattr(f_ops, kernel + "_plain")(p, *args, **kw)
            legal, _ = autotune.legal_candidates(kernel, name, (13, 1100, 70))
            for cand in legal:
                bk = fused_ring(kernel, p.n_digits, cand["bm"], cand["bn"])[0]
                sp = f_ops.splits_for(13, 1100, 70, cand["bm"], cand["bn"],
                                      bk, sms, f_ops.MIN_STEPS[kernel])
                if sp < 2:
                    bad.append(f"{kernel} {name} {label} {cand}: no split")
                case(kernel, f"{name} {label} tile {_blk(cand)} split {sp}",
                     lambda k=kernel, c=cand, a=args, w=kw: getattr(
                         f_ops, k)(p, *a, **w, **c),
                     lambda w=want: w, timed=False)
    torch.cuda.synchronize()
    launches["kernels"] = _launches()
    if bad:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(bad))
    print("[kernels] ok: every RNS kernel bit-equal to its plain version, "
          "flash_attention within its tolerance")


@contextlib.contextmanager
def _recording(torch, calls: dict, off_table: list | None = None,
               in_step: dict | None = None):
    """Keep, for each distinct call the six RNS wrappers see (kernel,
    profile, input shapes and dtypes, options), its number of calls and
    a copy of the inputs of its first call inside an engine step (of
    its first call at all until then: the engine's build warms its
    programs up on zero inputs): what [kernels] checks and times.
    ``in_step["on"]`` says whether a step is running (``_step_launches``
    sets it).  With ``off_table``, also hold every launch's blocks to
    the block table in force -- its row for the launch's bucket, or the
    defaults when the table is empty -- appending each launch that is
    not.  The wrappers themselves, and their launch counts, are
    untouched."""
    from repro_torch.kernels import autotune

    mods = _kernel_mods()
    saved = {name: getattr(mods[name], name) for name in RNS_KERNELS}
    table = autotune._load() if off_table is not None else None
    in_step = in_step if in_step is not None else {}

    def copies(tensors):
        return tuple(t.detach().clone() if torch.is_tensor(t) else t
                     for t in tensors)

    def recorder(name, fn):
        def call(profile, *tensors, **kw):
            key = (name, getattr(profile, "name", profile),
                   tuple((tuple(t.shape), str(t.dtype)) if torch.is_tensor(t)
                         else repr(t) for t in tensors),
                   tuple(sorted((k, repr(v)) for k, v in kw.items())))
            entry = calls.get(key)
            stepping = in_step.get("on", False)
            if entry is None:
                calls[key] = entry = {
                    "kernel": name, "profile": profile, "calls": 0,
                    "args": copies(tensors), "kw": dict(kw),
                    "from_step": stepping}
            elif stepping and not entry["from_step"]:
                entry["args"], entry["from_step"] = copies(tensors), True
            entry["calls"] += 1
            before = _launches()[name]
            out = fn(profile, *tensors, **kw)
            if table is not None and _launches()[name] > before:
                bucket, blocks = autotune.last_launch[name]
                row = table.get(bucket)
                want = dict(autotune.DEFAULTS[name],
                            **(row["blocks"] if row else {}))
                if blocks != want or (table and row is None):
                    off_table.append((bucket, blocks))
            return out
        return call

    for name in RNS_KERNELS:
        setattr(mods[name], name, recorder(name, saved[name]))
    try:
        yield calls
    finally:
        for name in RNS_KERNELS:
            setattr(mods[name], name, saved[name])


@contextlib.contextmanager
def _step_launches(log: list, in_step: dict):
    """Append (step stats, kernel launches made inside that step) for
    every ContinuousEngine.step run in the block; ``in_step["on"]`` is
    True while one runs."""
    from repro_torch.serve.engine import ContinuousEngine

    step = ContinuousEngine.step

    def counted(self):
        before = _launches()
        in_step["on"] = True
        try:
            out = step(self)
        finally:
            in_step["on"] = False
        after = _launches()
        log.append((out, {k: after[k] - before[k] for k in after}))
        return out

    ContinuousEngine.step = counted
    try:
        yield log
    finally:
        ContinuousEngine.step = step


def _kernel_kind(name: str) -> str | None:
    """The wrapper whose kernel a profiler event names (its demangled or
    mangled name), or None for a kernel of PyTorch's."""
    if "rns_encode_residues_kernel" in name:
        return "rns_fused_encode_matmul"
    if "rns_fused_mma_kernel" in name:     # AT: float x (the dot) or residues
        dot = "rns_fused_mma_kernel<float" in name or \
            "rns_fused_mma_kernelIf" in name
        return "rns_fused_dot" if dot else "rns_fused_matmul_normalize"
    for kind in ("rns_convert", "rns_matmul", "rns_normalize",
                 "flash_attention"):
        if f"{kind}_kernel" in name:
            return kind
    return None


def _graph_kernel_names(graph) -> list[str]:
    """The kernel of every kernel node of a captured ``torch.cuda.CUDAGraph``
    (kept with ``keep_graph=True``), by its mangled name, read from
    ``libcuda`` (``cuGraphGetNodes``): a replay launches each node once,
    so this is what every replay runs, whatever a profiler records."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    class KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = ([("func", ctypes.c_void_p)]
                    + [(n, ctypes.c_uint) for n in
                       ("gx", "gy", "gz", "bx", "by", "bz", "smem")]
                    + [(n, ctypes.c_void_p) for n in
                       ("kernel_params", "extra", "kern", "ctx")])

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} returned CUresult {rc}")

    def walk(g, names):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            if kind.value == 4:                 # CU_GRAPH_NODE_TYPE_GRAPH
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", node,
                     ctypes.byref(child))
                walk(child, names)
            if kind.value != 0:                 # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            params = KernelNodeParams()
            call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
            name = ctypes.c_char_p()
            if params.func:
                call("cuFuncGetName", ctypes.byref(name),
                     ctypes.c_void_p(params.func))
            else:
                call("cuKernelGetName", ctypes.byref(name),
                     ctypes.c_void_p(params.kern))
            names.append(name.value.decode())
        return names

    return walk(ctypes.c_void_p(graph.raw_cuda_graph()), [])


def _replay_kernels(torch, engine, program: str = "decode") -> dict:
    """The kernels of the engine's captured ``program`` ("decode",
    "verify" or "mixed"; a bucketed Engine's "decode(B)"), and one replay
    of it under torch.profiler on the trash page: the tables are zeroed
    first, no row is active and every lane is a pad lane (a bucketed
    engine's caches get lengths 0: the replay writes position 0).

    ``by_kernel`` / ``rns_kernels`` / ``all_kernels`` count the graph's
    kernel nodes by wrapper (what every replay launches);
    ``profiled_by_kernel`` / ``profiled_kernels`` are what the profiler
    recorded of the one replay, which must be more than nothing and no
    more than the graph holds; ``device_ms`` and the top 20 kernel names
    by device time are the profiler's."""
    from torch.profiler import ProfilerActivity, profile

    prog = engine.programs[program]
    if prog.graph is None:
        raise AssertionError(f"the {program} step was not captured")
    nodes = _graph_kernel_names(prog.graph)
    by_kind, by_name = {}, {}
    for name in nodes:
        kind = _kernel_kind(name)
        if kind is not None:
            by_kind[kind] = by_kind.get(kind, 0) + 1
            by_name[name[:120]] = by_name.get(name[:120], 0) + 1
    inputs = {}
    if hasattr(engine, "_caches"):
        for cache in engine._caches.values():
            cache.lengths.zero_()
    else:
        engine.cache.block_table.zero_()
        engine.cache.lengths.zero_()
        R = engine.pcfg.max_seqs
    if program == "decode":
        inputs = {"token": torch.zeros((R, 1), dtype=torch.int64),
                  "active": torch.zeros((R,), dtype=torch.bool)}
    elif program == "verify":
        inputs = {"window": torch.zeros((R, engine.spec_window),
                                        dtype=torch.int64),
                  "active": torch.zeros((R,), dtype=torch.bool),
                  "caps": torch.zeros((R,), dtype=torch.int64)}
    elif program == "mixed":
        N = engine.scfg.token_budget
        inputs = {"tokens": torch.zeros((N,), dtype=torch.int64),
                  "seg": torch.full((N,), -1, dtype=torch.int64),
                  "pos": torch.zeros((N,), dtype=torch.int64),
                  "dec": torch.zeros((N,), dtype=torch.bool),
                  "valid": torch.zeros((N,), dtype=torch.bool)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)        # margins: the replay lies well inside
        prog.run(**inputs)      # the profiler's window
        torch.cuda.synchronize()
        time.sleep(0.01)
    seen, seen_total, device_us, timed = {}, 0, 0.0, []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
            continue
        seen_total += ev.count
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        device_us += dt
        timed.append((dt, ev.count, ev.key[:120]))
        kind = _kernel_kind(ev.key)
        if kind is not None:
            seen[kind] = seen.get(kind, 0) + ev.count
    if seen_total == 0:
        raise AssertionError(f"torch.profiler sees no kernel in a replayed "
                             f"{program} step")
    if any(n > by_kind.get(k, 0) for k, n in seen.items()):
        raise AssertionError(f"a replayed {program} step: the profiler saw "
                             f"{seen}, more than the graph's {by_kind}")
    if seen != by_kind:
        print(f"  note: the profiler recorded {seen} of the {program} "
              f"graph's {by_kind} kernel nodes in one replay")
    top = [{"kernel": name, "calls": n, "device_us": dt,
            "share": dt / device_us if device_us else None}
           for dt, n, name in sorted(timed, reverse=True)[:20]]
    return {"by_kernel": by_kind, "rns_kernels": sum(by_kind.values()),
            "all_kernels": len(nodes), "names": by_name,
            "profiled_by_kernel": seen, "profiled_kernels": seen_total,
            "device_ms": device_us / 1e3, "top20_by_device_time": top}


def _print_top(label: str, replay: dict):
    print(f"  {label}: one replayed step, {replay['all_kernels']} kernel "
          f"nodes ({replay['profiled_kernels']} recorded by the profiler), "
          f"{replay['device_ms']:.4f} ms of device time; top 20 by time:")
    for row in replay["top20_by_device_time"]:
        share = row["share"] if row["share"] is not None else float("nan")
        print(f"    {row['device_us']:10.2f} us {share:6.1%} "
              f"x{row['calls']:<4d} {row['kernel']}")


def _serve_numbers(engine, stats, wall, decode_launches) -> dict:
    steps = stats["steps"]
    decode_only = [s for s in steps if not s["admitted"] and s["decoded"]]
    return {
        "tokens_per_s": stats["tokens_per_s"],
        "wall_s": stats["wall_s"], "setup_and_run_s": wall,
        "steps": len(steps), "tokens": stats["total_new_tokens"],
        "prompt_pad": engine.prompt_pad, "decode_rows": engine.pcfg.max_seqs,
        "ttft_p50_s": stats["ttft_p50_s"],
        "latency_p50_s": stats["latency_p50_s"],
        "decode_step_ms_median": 1e3 * statistics.median(
            s["step_time_s"] for s in decode_only) if decode_only else None,
        "decode_step_rns_ops": (decode_only[0]["rns_ops"].as_dict()
                                if decode_only else None),
        "decode_step_launches": decode_launches,
        "captures": stats["captures"],
    }


SIDE_BY_SIDE = ("tokens_per_s", "ttft_p50_s", "decode_step_ms_median",
                "device_idle_share_vs_unprofiled_wall", "device_idle_share",
                "device_busy_ms", "captures", "rns_kernels_per_decode_step")


def phase_serve(torch, path: str, launches: dict, calls: dict, *,
                rerun: str = ""):
    """Serve the SERVE traffic at full width on one path of SERVE_PATHS,
    eager then captured.  The eager serve runs with counts from 0 and
    every distinct wrapper call recorded and merged into ``calls``;
    ``launches[run label]`` gets its launches.  The captured serve must
    give its tokens and rns_ops, capture each phase once, and replay
    the eager decode step's kernels.  The captured serve is re-served
    under torch.profiler (an eager serve is not: the profiler's own
    processing of one takes two minutes).  ``rerun``: a run of [serve_tuned],
    labelled ``<path>_<rerun>``, with every launch held to the block
    table in force and no merge into ``calls``.  Returns ({"eager":
    numbers, "captured": numbers}, greedy tokens)."""
    from collections import Counter

    from repro_torch.launch.serve import serve
    from repro_torch.models.resident import resident_profiles

    serve_kw, per_layer_ops = SERVE_PATHS[path]
    label = f"{path}_{rerun}" if rerun else path
    off_table: list | None = [] if rerun else None
    clock = {"start": time.perf_counter()}

    # one short request first, so that first-use costs (kernel libraries
    # loaded, cuBLAS handles, the caching allocator) stay out of the
    # measured run: without it one call's TTFT p50 was 2.1 s, not 0.9 s
    serve("smollm-135m", full=True, rns="rns9", device="cuda", requests=1,
          prompt_lens=(7,), new=2, max_seqs=SERVE["max_seqs"],
          graphs=False, **serve_kw)
    torch.cuda.synchronize()
    _reset_launches()
    steps_log: list = []
    path_calls: dict = {}
    in_step: dict = {}
    t0 = time.perf_counter()
    with _recording(torch, path_calls, off_table, in_step), \
            _step_launches(steps_log, in_step):
        engine, results, stats = serve("smollm-135m", full=True, rns="rns9",
                                       device="cuda", graphs=False, **SERVE,
                                       **serve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[label] = run = _launches()
    cfg = engine.cfg
    assert cfg.n_layers == FULL_LAYERS and cfg.d_model == 576
    steps = stats["steps"]
    per_step = {k: v * FULL_LAYERS for k, v in per_layer_ops.items()}
    for s in steps:                 # the JAX engine's rule: decode + prefills
        want = {k: v * (1 + len(s["admitted"])) for k, v in per_step.items()}
        assert s["rns_ops"].as_dict() == want, (s["step"], s["rns_ops"])
    assert all(s["rns_ops"].fallbacks == 0 for s in steps)
    want_launch = DECODE_LAUNCHES[path]
    decode_launches = [lc for st, lc in steps_log
                       if not st["admitted"] and st["decoded"]]
    assert decode_launches, "no decode-only step"
    for lc in decode_launches:
        assert lc == want_launch, (path, lc)
    for k, n in run.items():
        assert (n > 0) == (want_launch[k] > 0), (path, k, n)
    calls_by_kernel = {k: sum(e["calls"] for e in path_calls.values()
                              if e["kernel"] == k) for k in run}
    assert calls_by_kernel == run, (calls_by_kernel, run)
    if rerun:
        n_launched = sum(run.values())
        assert not off_table, (f"{len(off_table)} of {n_launched} launches "
                               f"off the block table, e.g. {off_table[:3]}")
    else:
        _merge_calls(calls, path_calls)
    assert len(results) == SERVE["requests"]
    for toks in results.values():
        assert len(toks) == SERVE["new"]
        assert ((toks >= 0) & (toks < cfg.vocab)).all()
    eager = _serve_numbers(engine, stats, wall, decode_launches[0])
    eager.update(launches=dict(run), distinct_calls=len(path_calls),
                 rns_kernels_per_decode_step=sum(decode_launches[0].values()))
    if rerun:
        eager["launches_on_the_block_table"] = sum(run.values())
    clock["eager_served"] = time.perf_counter()
    profiles = Counter(resident_profiles(engine.model).values())
    del engine

    # the same traffic through the captured steps
    t0 = time.perf_counter()
    cengine, cresults, cstats = serve("smollm-135m", full=True, rns="rns9",
                                      device="cuda", graphs=True, **SERVE,
                                      **serve_kw)
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    if _tokens(cresults) != _tokens(results):
        raise AssertionError(f"{label}: captured greedy tokens differ from "
                             "the eager serve's")
    if [s["rns_ops"].as_dict() for s in cstats["steps"]] != [
            s["rns_ops"].as_dict() for s in steps]:
        raise AssertionError(f"{label}: captured rns_ops differ from the "
                             "eager serve's")
    if cstats["captures"] != {"decode": 1, "prefill": 1}:
        raise AssertionError(f"{label}: captures {cstats['captures']}")
    cprofiles = Counter(resident_profiles(cengine.model).values())
    if cprofiles != profiles:
        raise AssertionError(f"{label}: profiles {cprofiles} vs {profiles}")
    captured = _serve_numbers(cengine, cstats, cwall, None)
    clock["captured_served"] = time.perf_counter()
    captured.update(_profile_serve(torch, cengine, cresults,
                                   cstats["wall_s"]))
    clock["captured_profiled"] = time.perf_counter()
    replay = _replay_kernels(torch, cengine)
    captured["replayed_decode_step"] = replay
    if not rerun:
        _print_top(f"{label} decode", replay)
    captured["rns_kernels_per_decode_step"] = replay["rns_kernels"]
    if replay["all_kernels"] == 0:
        raise AssertionError("the captured decode step holds no kernel")
    want_rns = {k: n for k, n in want_launch.items() if n}
    if replay["by_kernel"] != want_rns:
        raise AssertionError(f"{label}: a replayed decode step ran "
                             f"{replay['by_kernel']}, the eager step "
                             f"launched {want_rns}")
    del cengine
    marks = list(clock.items())
    out = {"eager": eager, "captured": captured,
           "profiles": dict(profiles),
           "phase_s": {k: t - t_prev for (_, t_prev), (k, t)
                       in zip(marks, marks[1:] + [("replayed",
                                                   time.perf_counter())])}}
    print(json.dumps({label: out}))
    print(f"  {label} profiles: {dict(profiles) or 'none (re-encoded)'}")
    for name in SIDE_BY_SIDE:
        print(f"  {label} {name}: eager {eager.get(name, 'not measured')}, "
              f"captured {captured.get(name, 'not measured')}")
    print(f"[{label}] ok")
    return out, _tokens(results)


def _profile_serve(torch, engine, results, unprofiled_wall_s) -> dict:
    """Device busy share over the serve traffic (prefills and decode
    steps, the same prompts), re-served on the warm engine under
    torch.profiler.  The profiler's host cost lengthens that run, so the
    share is given against its own wall time and against the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import request_prompts

    prompts = request_prompts(engine.cfg.vocab, SERVE["requests"],
                              SERVE["prompt_lens"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again, _ = engine.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    same = ([results[r].tolist() for r in sorted(results)]
            == [again[r].tolist() for r in sorted(again)])
    busy_us, by_name = 0.0, {}
    for ev in prof.key_averages():
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA") and dt:
            busy_us += dt
            for k in ("rns_convert", "rns_matmul", "rns_normalize",
                      "rns_fused_mma", "rns_encode_residues"):
                if k in ev.key:     # B.4 + B.6; B.5 on its own
                    by_name[k] = by_name.get(k, 0.0) + dt / 1e3
                    break
    out = {"profiled_run": "the serve traffic re-served under "
                           "torch.profiler on the warm engine",
           "profiled_wall_s": wall, "profiled_tokens_equal": same}
    if busy_us == 0:
        out["device_idle_share"] = "no device time in the profile: " \
                                   "not measured"
        return out
    busy_s = busy_us / 1e6
    out.update(device_busy_ms=busy_us / 1e3,
               device_idle_share=1 - busy_s / wall,
               device_idle_share_vs_unprofiled_wall=(
                   1 - busy_s / unprofiled_wall_s),
               kernel_device_ms=by_name)
    return out


def _first_logits(torch, M, model, cfg, prompts, device):
    out = []
    for pr in prompts:
        tok = torch.as_tensor(pr[None].astype("int64"), device=device)
        n = torch.tensor([len(pr)], device=device)
        out.append(M.prefill_ragged(model, cfg, tok, n)[0].cpu())
    return out


def _tokens(results) -> list:
    return [results[r].tolist() for r in sorted(results)]


def phase_identity(torch):
    from repro_torch.configs.base import at_depth, get_config
    from repro_torch.core.rns_matmul import RnsDotConfig
    from repro_torch.models import model as M
    from repro_torch.models.resident import encode_resident, resident_profiles
    from repro_torch.serve.engine import ContinuousEngine, ServeConfig
    import numpy as np

    cfg = dataclasses.replace(at_depth(get_config("smollm-135m"),
                                       IDENTITY_LAYERS),
                              rns=RnsDotConfig(profile="rns9", qx=8, qw=8))
    cpu_model = M.init_model(cfg, seed=1, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 33, 60)]
    # the RNS projections alone are device-independent: the same float
    # input gives bit-equal outputs on the card (kernels) and the CPU
    from repro_torch.core.quantize import token_mask
    from repro_torch.core.rns_matmul import rns_multi_dot

    x = torch.randn((3, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    ws = (cpu_model.blocks[0].mlp.wi, cpu_model.blocks[0].mlp.wg)
    with token_mask(torch.ones(3, 5, dtype=torch.bool), per_token=True):
        yc = rns_multi_dot(x, ws, cfg.rns)
    with token_mask(torch.ones(3, 5, dtype=torch.bool, device="cuda"),
                    per_token=True):
        yg = rns_multi_dot(x.cuda(), tuple(w.cuda() for w in ws), cfg.rns)
    same = all(torch.equal(g.cpu(), c) for g, c in zip(yg, yc))
    print(f"  rns_multi_dot on one float input, card == cpu bit for bit: "
          f"{same}")
    if not same:
        raise AssertionError("RNS projections differ between card and cpu")
    # what a last-bit difference alone does on the CPU: every weight of
    # layer 0's attention output projection (a float op) moved by one ulp
    nudged = copy.deepcopy(cpu_model)
    w = nudged.blocks[0].attn.wo
    w.data = torch.nextafter(w.data, torch.full_like(w.data, float("inf")))
    float_cfg = dataclasses.replace(cfg, rns=None)
    lc = _first_logits(torch, M, cpu_model, cfg, prompts, "cpu")
    lg = _first_logits(torch, M, gpu_model, cfg, prompts, "cuda")
    lf = _first_logits(torch, M, cpu_model, float_cfg, prompts, "cpu")
    ln = _first_logits(torch, M, nudged, cfg, prompts, "cpu")

    def gap(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    worst, quant, ulp = gap(lg, lc), gap(lf, lc), gap(ln, lc)
    kw = dict(max_cache=80, max_new_tokens=8, page_size=16, max_seqs=4)
    res_g, _ = ContinuousEngine(gpu_model, ServeConfig(**kw),
                                device="cuda").run(prompts)
    res_c, _ = ContinuousEngine(cpu_model, ServeConfig(**kw),
                                device="cpu").run(prompts)
    match = sum(int(a == b) for ta, tb in zip(_tokens(res_c), _tokens(res_g))
                for a, b in zip(ta, tb))
    total = sum(len(v) for v in res_c.values())
    print(f"  first-step logits max |card - cpu| = {worst} "
          f"(tolerance {LOGIT_TOL}); on the cpu alone, one ulp on one "
          f"float weight matrix: {ulp}; rns9 8-bit datapath vs float on "
          f"the cpu: {quant}")
    print(f"  matching greedy tokens: {match}/{total}")
    if not LOGIT_TOL < quant:
        raise AssertionError(f"tolerance {LOGIT_TOL} would not tell the "
                             f"datapath ({quant}) from plain float")
    if not worst <= LOGIT_TOL:
        raise AssertionError(f"first-step logits differ by {worst}")
    if match != total:
        raise AssertionError(f"greedy tokens differ: {match}/{total}")

    # on the card: fused kernels on resident weights == the per-op cuda
    # path re-encoding its weights, bit for bit (JAX promises resident ==
    # re-encode and fused == unfused)
    fused_cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="cuda_fused"))
    res_model = encode_resident(copy.deepcopy(gpu_model), fused_cfg)
    lr = _first_logits(torch, M, res_model, fused_cfg, prompts, "cuda")
    l_equal = all(torch.equal(a, b) for a, b in zip(lr, lg))
    res_f, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        rns_backend="cuda_fused", resident_weights=True, **kw),
        device="cuda").run(prompts)
    t_equal = _tokens(res_f) == _tokens(res_g)
    print(f"  card, fused resident per-op vs re-encode per-op: logits "
          f"bit-equal {l_equal}, greedy tokens equal {t_equal}")
    if not (l_equal and t_equal):
        raise AssertionError("fused resident per-op path differs from the "
                             "re-encode per-op path on the card")

    # the deferred fused path, card vs CPU
    def_cfg = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="cuda_fused", defer=True))
    def_cpu = encode_resident(copy.deepcopy(cpu_model), def_cfg)
    def_gpu = encode_resident(copy.deepcopy(gpu_model), def_cfg)
    ldc = _first_logits(torch, M, def_cpu, def_cfg, prompts, "cpu")
    ldg = _first_logits(torch, M, def_gpu, def_cfg, prompts, "cuda")
    d_worst, d_quant = gap(ldg, ldc), gap(lf, ldc)
    dkw = dict(rns_backend="cuda_fused", rns_defer=True,
               resident_weights=True, **kw)
    res_dg, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        **dkw), device="cuda").run(prompts)
    res_dc, _ = ContinuousEngine(copy.deepcopy(cpu_model), ServeConfig(
        **dkw), device="cpu").run(prompts)
    d_match = sum(int(a == b) for ta, tb in zip(_tokens(res_dc),
                                                _tokens(res_dg))
                  for a, b in zip(ta, tb))
    d_total = sum(len(v) for v in res_dc.values())
    print(f"  deferred fused path: first-step logits max |card - cpu| = "
          f"{d_worst} (tolerance {LOGIT_TOL}); its 8-bit datapath vs float "
          f"on the cpu: {d_quant}; matching greedy tokens: "
          f"{d_match}/{d_total}")
    if not LOGIT_TOL < d_quant:
        raise AssertionError(f"tolerance {LOGIT_TOL} would not tell the "
                             f"deferred datapath ({d_quant}) from float")
    if not d_worst <= LOGIT_TOL:
        raise AssertionError(f"deferred first-step logits differ by "
                             f"{d_worst}")
    if d_match != d_total:
        raise AssertionError(f"deferred greedy tokens differ: "
                             f"{d_match}/{d_total}")

    # the deferred fused path with per-layer profiles, card vs CPU: the
    # same profiles selected from the same weights on both devices
    pl_cpu = encode_resident(copy.deepcopy(cpu_model), def_cfg,
                             per_layer_profiles=True)
    pl_gpu = encode_resident(copy.deepcopy(gpu_model), def_cfg,
                             per_layer_profiles=True)
    prof_c, prof_g = resident_profiles(pl_cpu), resident_profiles(pl_gpu)
    lpc = _first_logits(torch, M, pl_cpu, def_cfg, prompts, "cpu")
    lpg = _first_logits(torch, M, pl_gpu, def_cfg, prompts, "cuda")
    p_worst = gap(lpg, lpc)
    pkw = dict(dkw, per_layer_profiles=True)
    res_pg, _ = ContinuousEngine(copy.deepcopy(gpu_model), ServeConfig(
        **pkw), device="cuda").run(prompts)
    res_pc, _ = ContinuousEngine(copy.deepcopy(cpu_model), ServeConfig(
        **pkw), device="cpu").run(prompts)
    p_match = sum(int(a == b) for ta, tb in zip(_tokens(res_pc),
                                                _tokens(res_pg))
                  for a, b in zip(ta, tb))
    p_total = sum(len(v) for v in res_pc.values())
    print(f"  per-layer profiles {sorted(set(prof_g.values()))} (card) "
          f"{sorted(set(prof_c.values()))} (cpu); first-step logits max "
          f"|card - cpu| = {p_worst} (tolerance {LOGIT_TOL}); matching "
          f"greedy tokens: {p_match}/{p_total}")
    if prof_c != prof_g:
        raise AssertionError(f"per-layer profiles differ: card {prof_g}, "
                             f"cpu {prof_c}")
    if not p_worst <= LOGIT_TOL:
        raise AssertionError(f"per-layer first-step logits differ by "
                             f"{p_worst}")
    if p_match != p_total:
        raise AssertionError(f"per-layer greedy tokens differ: "
                             f"{p_match}/{p_total}")
    print("[identity] ok")


def _bit_equal(torch, got, want) -> bool:
    """float32 results equal bit for bit (-0.0 is not 0.0; NaN == NaN)."""
    return (got.shape == want.shape and got.dtype == want.dtype and
            torch.equal(got.contiguous().view(torch.int32),
                        want.contiguous().view(torch.int32)))


def _traffic(torch, fn) -> tuple[int, int]:
    """(ops, bytes) of one call of ``fn``, op by op at the aten level:
    each tensor an op reads counted once, each tensor it writes once
    (an in-place op's first argument as written only); views move
    nothing.  The least traffic of running the same ops one kernel each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    tally = [0, 0]

    def nbytes(t):
        return t.numel() * t.element_size() if torch.is_tensor(t) else 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            if any(torch.is_tensor(o) and o._is_view() for o in outs):
                return out
            ins = [a for a in list(args) + list(kwargs.values())
                   if torch.is_tensor(a)]
            inplace = func._schema.name.endswith("_")
            tally[0] += 1
            tally[1] += sum(nbytes(t) for t in ins[int(inplace):]) + sum(
                nbytes(o) for o in outs)
            return out

    with Count():
        fn()
    return tally[0], tally[1]


def phase_fractional(torch, dev, record, launches):
    """Fractional residue tensors through B.3/B.4/B.6 (counted), the
    Mandelbrot demo full size and cropped (card captured / eager / CPU),
    the deep proof, and the scaled kernels against their plain versions.
    Adds its timed rows to ``record`` and its launches to ``launches``."""
    import numpy as np

    from repro_torch.core import fractional as fr
    from repro_torch.core import tensor as rt
    from repro_torch.core.moduli import get_profile
    from repro_torch.launch import mandelbrot as mb

    bad = []
    p = get_profile("rns9")
    D, N = 576, 1536                # smollm-135m's MLP widths
    g = torch.Generator().manual_seed(5)

    def frac(v, device, dtype):
        """A fractional residue tensor (frac_exp 1) of the float ``v``."""
        return rt.RnsTensor(fr.fr_encode(p, v.to(device)).to(dtype),
                            torch.ones((), device=device), p.name,
                            math.log2(float(v.abs().max()) * p.M_f + 1), 1)

    w_i = torch.randn((D, N), generator=g) * 0.05      # wi / wg: D -> N
    w_o = torch.randn((N, D), generator=g) * 0.05      # wo: N -> D
    rows = {"decode": torch.randn((8, 1, D), generator=g),
            "prefill": torch.randn((1, 144, D), generator=g)}
    hs = {k: torch.randn(v.shape[:-1] + (N,), generator=g) * 0.5
          for k, v in rows.items()}

    def chain(device):
        """rt_dot (B.4, frac_exp 1), rt_matmul_decode (B.6, frac_exp 2),
        rt_decode(rt_matmul) (B.2 then B.3, frac_exp 2) on each row."""
        Wi = frac(w_i, device, torch.int8)
        Wo = frac(w_o, device, torch.int8)
        out = {}
        for k, x in rows.items():
            A = frac(hs[k], device, torch.int32)
            out[k + " dot"] = rt.rt_dot(x.to(device), Wi, bits=8,
                                        backend="cuda_fused")
            out[k + " matmul_decode"] = rt.rt_matmul_decode(
                A, Wo, backend="cuda_fused")
            out[k + " decode"] = rt.rt_decode(rt.rt_matmul(
                A.astype_digits(torch.int8), Wo, backend="cuda"),
                backend="cuda")
        return out

    _reset_launches()
    got = chain(dev)
    torch.cuda.synchronize()
    launches["fractional"] = run = _launches()
    want = chain("cpu")
    for k, y in got.items():
        x = rows[k.split()[0]].double()
        ref = (x @ w_i.double() if k.endswith("dot")
               else hs[k.split()[0]].double() @ w_o.double())
        err = float((y.cpu().double() - ref).abs().max())
        same = _bit_equal(torch, y.cpu(), want[k])
        print(f"  frac_exp {1 if k.endswith('dot') else 2} {k}: "
              f"{list(y.shape)} card == cpu bit for bit {same}, max |y - "
              f"float64| = {err:.3g} (|ref| max "
              f"{float(ref.abs().max()):.3g})")
        if not same or not err <= 0.02 * float(ref.abs().max()):
            bad.append(f"fractional chain {k}")
    print(f"  launches on the fractional path: {run}")
    for name in ("rns_normalize", "rns_fused_dot",
                 "rns_fused_matmul_normalize"):
        if not run[name]:
            bad.append(f"{name} not launched on the fractional path")

    # ---- the Mandelbrot demo, full size: captured, then eager
    iters, (W, H) = 256, (1920, 1080)
    cr, ci = mb.view(W, H)
    probe = mb.MandelbrotRender("rns12", cr, ci, iters, device=dev,
                                graphs=False)
    n_ops, step_bytes = _traffic(torch, lambda: mb.mandelbrot_step(
        probe.profile, iters, **probe.inputs))
    del probe
    bound_s = step_bytes * iters / HBM_BYTES_PER_S
    print(f"  mandelbrot step: {n_ops} aten ops moving {step_bytes} bytes "
          f"({step_bytes / (W * H):.1f} a pixel); bound of the render "
          f"{bound_s:.4f} s (bytes)")
    full, st = mb.render("rns12", cr, ci, iters, device=dev)
    torch.cuda.empty_cache()
    eager, st_e = mb.render("rns12", cr, ci, iters, device=dev,
                            graphs=False)
    torch.cuda.empty_cache()
    agree = float(np.mean(mb.escape_f64(cr, ci, iters, device=dev) == full))
    print(f"  mandelbrot rns12 {W}x{H} x {iters} iterations: captured "
          f"{st['seconds']:.4f} s ({st['pixel_iters_per_s']:.6g} "
          f"pixel-iterations/s, build {st['build_s']:.3f} s, captures "
          f"{st['captures']}), eager {st_e['seconds']:.4f} s "
          f"({st_e['pixel_iters_per_s']:.6g}/s); escape counts equal "
          f"{np.array_equal(full, eager)}; agreement with float64 "
          f"{agree:.6f}; captured / bound {st['seconds'] / bound_s:.3f}")
    if not (np.array_equal(full, eager) and st["captures"] == 1
            and st_e["captures"] == 0 and agree > 0.9):
        bad.append("mandelbrot full render")

    # ---- a 256 x 256 crop: captured, eager, on the CPU
    r0, c0 = (H - 256) // 2, (W - 256) // 2
    crop = (slice(r0, r0 + 256), slice(c0, c0 + 256))
    runs = {"captured": mb.render("rns12", cr[crop], ci[crop], iters,
                                  device=dev),
            "eager": mb.render("rns12", cr[crop], ci[crop], iters,
                               device=dev, graphs=False),
            "cpu": mb.render("rns12", cr[crop], ci[crop], iters,
                             device="cpu")}
    same = all(np.array_equal(e, full[crop]) for e, _ in runs.values())
    print("  mandelbrot crop 256x256 x 256: " + ", ".join(
        f"{k} {v[1]['seconds']:.4f} s ({v[1]['pixel_iters_per_s']:.6g}/s)"
        for k, v in runs.items())
        + f"; escape counts equal (and equal to the full render's "
        f"window) {same}")
    if not same:
        bad.append("mandelbrot crop: card captured / eager / cpu differ")

    # ---- the deep proof
    deep = mb.deep_precision_proof(dev)
    deep_cpu = mb.deep_precision_proof("cpu")
    print(f"  rns24_deep ({deep['frac_bits']:.1f} fractional bits): "
          f"float64(c1) == float64(c0) {deep['f64_equal']}; orbits differ "
          f"by {float(deep['diff']):.6e} after 30 iterations; card == cpu "
          f"{deep['diff'] == deep_cpu['diff']}")
    if not (deep["f64_equal"] and deep["diff"] != 0
            and deep["diff"] == deep_cpu["diff"]):
        bad.append("deep proof")

    # ---- B.3, B.4, B.6 with a scaled table vs their plain versions
    mods = _kernel_mods()
    gd = torch.Generator(device=dev).manual_seed(6)
    b_i = _residues(torch, p, (D, N), gd, dev).to(torch.int8)
    b_o = _residues(torch, p, (N, D), gd, dev).to(torch.int8)
    inputs = {}
    for k, shape in (("decode", (8, 1)), ("prefill", (1, 144))):
        x = torch.randn(shape + (D,), generator=gd, device=dev)
        s = 127.0 / x.abs().amax(dim=-1, keepdim=True)
        a = _residues(torch, p, shape + (N,), gd, dev)
        inputs[k] = {"rns_normalize": (a,),
                     "rns_fused_dot": (x, s, b_i),
                     "rns_fused_matmul_normalize": (a, b_o)}
    scales = {"M_f^-1": 1.0 / p.M_f, "M_f^-2": 1.0 / float(p.M_f) ** 2,
              "M_f^-10": 1.0 / float(p.M_f) ** 10}
    for kernel in ("rns_normalize", "rns_fused_dot",
                   "rns_fused_matmul_normalize"):
        wrapper = getattr(mods[kernel], kernel)
        plain = getattr(mods[kernel], kernel + "_plain")
        kw = {"bits": 8} if kernel == "rns_fused_dot" else {}
        for row, ins in inputs.items():
            args = ins[kernel]
            label, nbytes, ops, rate = _cost(torch, kernel, p.n_digits, args,
                                             kw)
            for sname, inv in scales.items():
                def fn(a=args, i=inv):
                    return wrapper(p, *a, inv_scale=i, **kw)

                def pl(a=args, i=inv):
                    return plain(p, *a, inv_scale=i, **kw)

                y, yp = fn(), pl()
                ok = _bit_equal(torch, y, yp)
                entry = {"case": f"rns9 {row} {label} inv_scale {sname}",
                         "max_abs_err": _max_abs_err(torch, y, yp),
                         "bit_equal": ok, "subnormal_weights": bool(
                             inv * 1.0 < 2.0 ** -126)}
                if row == "decode" and sname == "M_f^-2":
                    b, by = _bound(nbytes, ops, rate)
                    entry.update(
                        ms=_time_ms(torch, fn, 20),
                        unscaled_ms=_time_ms(
                            torch, lambda a=args: wrapper(p, *a, **kw), 20),
                        plain_ms=_time_ms(torch, pl, 5), bound_ms=b,
                        bound_by=by, library_ms=None)
                record.setdefault(kernel, []).append(entry)
                print(f"  {kernel:26s} {entry['case']:60s} " + " ".join(
                    f"{k}={v}" for k, v in entry.items() if k != "case"))
                if not ok:
                    bad.append(f"{kernel} {entry['case']}")
    if bad:
        raise AssertionError(f"[fractional] failed: {bad}")
    print("[fractional] ok")


# ------------------------------------------------------------- [train] ----
TRAIN_ARCH = "smollm-135m"
TRAIN_BIG = "tinyllama-1.1b"
#: its depth in [train]: 11 of 22 since [dist] came, for the run's time
TRAIN_BIG_LAYERS = 11
#: the corpus: SyntheticLM over the first 1024 token ids (the models'
#: logits still span their whole vocabulary).  Over all 49152 of
#: smollm-135m's ids a 20-step run has nothing to learn: 20 k tokens
#: of a near-uniform chain; its loss went 10.933 -> 10.974 (PERF.md)
TRAIN_DATA = dict(vocab=1024, seq_len=128, global_batch=8)
TRAIN_STEPS = 20
#: the float run's loss must fall at least this much over its steps
TRAIN_LOSS_DROP = 0.3
#: the RNS datapath of the train CLI's ``--rns``: rns9, 16-bit
#: activations, weights and gradients, the backward's products in RNS
TRAIN_RNS = dict(profile="rns9", qx=16, qw=16, qg=16, backward_rns=True)
#: JAX's op count of one smollm-135m loss evaluation on the per-op rns9
#: path at 16 bits over [8, 128] tokens: traced once, one scanned layer
#: (ROADMAP C.3), from
#:   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import dataclasses, \
#:   jax.numpy as jnp; from repro.configs.base import get_config; \
#:   from repro.core.rns_matmul import RnsDotConfig as R; \
#:   from repro.train.train_step import measure_rns_ops as m; \
#:   c = dataclasses.replace(get_config('smollm-135m'), rns=R(qx=16, \
#:   qw=16, qg=16), rns_targets='mlp'); \
#:   print(m(c, {'tokens': jnp.zeros((8, 128), jnp.int32)}))"
JAX_TRAIN_RNS_OPS = {"converts": 5, "matmuls": 3, "normalizes": 3,
                     "fused": 0, "fallbacks": 0, "weight_converts": 3}
#: step-1 loss on the card against the CPU port's on the same params and
#: batch (float32 sums in other orders; 16-bit requantizations)
TRAIN_CPU_TOL = 1e-4
#: the kernels each RNS path must launch
TRAIN_KERNELS = {
    "rns": ("rns_convert", "rns_matmul", "rns_normalize"),
    "fused": ("rns_convert", "rns_matmul", "rns_normalize", "rns_fused_dot"),
    "deferred": ("rns_convert", "rns_fused_encode_matmul",
                 "rns_fused_matmul_normalize", "rns_fused_dot")}


def _train_cfg(arch: str, kind: str):
    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig

    cfg = get_config(arch)
    if kind == "float":
        return cfg
    backend = "cuda" if kind == "rns" else "cuda_fused"
    r = RnsDotConfig(**TRAIN_RNS, backend=backend, defer=kind == "deferred")
    return dataclasses.replace(cfg, rns=r, rns_targets="mlp")


def _state_list(state: dict) -> list:
    """Every parameter, m, v and the step of a train state, in one
    order."""
    from repro_torch.train.train_step import state_tree

    t = state_tree(state)
    return [x.detach() for x in (
        *t["params"].values(), *t["opt"]["m"].values(),
        *t["opt"]["v"].values(), t["opt"]["step"])]


#: the host buffer ``_host_state`` copies into (page-locked, reused)
_HOST_STAGE: list = []


def _host_state(torch, state: dict) -> list:
    """``_state_list`` copied to the host, into one reused page-locked
    buffer (``train_step.HostStage``): the previous copy is
    overwritten."""
    from repro_torch.train.train_step import HostStage

    if not _HOST_STAGE:
        _HOST_STAGE.append(HostStage())
    return _HOST_STAGE[0].copy(_state_list(state))


def _state_equal(torch, a, b) -> bool:
    """Two train states (each a state dict on the card or its
    ``_host_state``) bit-equal: every parameter, m, v and the step,
    compared on the card."""
    a = a if isinstance(a, list) else _state_list(a)
    b = b if isinstance(b, list) else _state_list(b)
    dev = torch.device("cuda")
    return len(a) == len(b) and all(
        torch.equal(x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))
        for x, y in zip(a, b))


def _loss_grads(torch, model, cfg, batch):
    """(loss, aux loss, {name: gradient}) of one eager loss
    evaluation."""
    from repro_torch.models import model as M

    params = dict(model.named_parameters())
    loss, parts = M.loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), parts["aux"].detach(), dict(zip(params, grads))


def _differ(torch, a, b) -> list:
    """What differs between two ``_loss_grads`` results: "loss", "aux"
    and the names of the gradients not bit-equal."""
    bad = [k for k, x, y in (("loss", a[0], b[0]), ("aux", a[1], b[1]))
           if not torch.equal(x, y)]
    return bad + [k for k in a[2] if not torch.equal(a[2][k], b[2][k])]


def _grad_diff(torch, got: dict, want: dict) -> tuple[float, str]:
    """The largest |got - want| over all gradients, and its tensor."""
    worst, where = 0.0, ""
    for k, w in want.items():
        d = float((got[k].float().cpu() - w.float().cpu()).abs().max())
        if d > worst:
            worst, where = d, k
    return worst, where


#: the CPU port's step-1 check: its inputs, outputs and log
TRAIN_CPU_DIR = ROOT / "build" / "train_cpu_check"


def _split_cores() -> tuple[list[int], list[int]]:
    """(this process's cores, the CPU check's) while the check runs: the
    first quarter (at least 2) keeps the card's host loop, the check takes
    the rest.  With fewer than 4 cores both share all of them."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return cores, cores
    keep = max(2, len(cores) // 4)
    return cores[:keep], cores[keep:]


def _start_train_cpu_check(torch):
    """Draw smollm-135m's seed-0 weights on the card (those [train]
    draws) and the first batch, write them under TRAIN_CPU_DIR, and start
    the CPU port's step 1 on them in a child process
    (``--train-cpu-check``, on the cores :func:`_split_cores` gives it):
    minutes of the plain MRC over [9, 1024, 1536] residues, run while the
    card trains.  This thread moves to the other cores until
    :func:`_stop_train_cpu_check`.  Returns the process."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import train_step as ts

    shutil.rmtree(TRAIN_CPU_DIR, ignore_errors=True)
    TRAIN_CPU_DIR.mkdir(parents=True)
    model = ts.init_train_state(_train_cfg(TRAIN_ARCH, "rns"), 0,
                                torch.device("cuda"))["model"]
    tokens = SyntheticLM(DataConfig(**TRAIN_DATA)).batch(0)["tokens"]
    torch.save({"masters": {n: p.detach().cpu()
                            for n, p in model.named_parameters()},
                "tokens": torch.as_tensor(tokens)}, TRAIN_CPU_DIR / "in.pt")
    log = open(TRAIN_CPU_DIR / "log.txt", "w")
    try:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--train-cpu-check"], stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    proc.all_cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, _split_cores()[0])
    return proc


def _stop_train_cpu_check(proc):
    """Kill the child if it still runs; this thread gets its cores back."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    os.sched_setaffinity(0, proc.all_cores)


def _finish_train_cpu_check(torch, proc) -> dict:
    """Wait for the child (at most 15 min) and load what it wrote."""
    try:
        rc = proc.wait(timeout=900)
    finally:
        _stop_train_cpu_check(proc)
    if rc != 0:
        tail = (TRAIN_CPU_DIR / "log.txt").read_text()[-3000:]
        raise AssertionError(f"[train] the CPU check exited {rc}:\n{tail}")
    return torch.load(TRAIN_CPU_DIR / "out.pt")


def train_cpu_check() -> int:
    """``--train-cpu-check``: the CPU port (plain versions, no remat) on
    TRAIN_CPU_DIR's weights and batch: smollm-135m's per-op rns9 loss and
    gradients and the fused deferred resident path's loss, in two threads
    (each has serial stretches the other's ops fill), on the cores
    :func:`_split_cores` leaves it.  No CUDA."""
    cores = _split_cores()[1]
    os.sched_setaffinity(0, cores)  # before torch starts its threads
    os.nice(19)                     # the card's host loop comes first
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(len(cores))

    from repro_torch.models import model as M
    from repro_torch.models.resident import attach_resident

    inp = torch.load(TRAIN_CPU_DIR / "in.pt")
    batch = {"tokens": inp["tokens"]}
    out: dict = {}

    def cpu_model(c):
        m = M.Model(c, device="cpu")
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(inp["masters"][n])
        return m

    def plain(kind):
        c = _train_cfg(TRAIN_ARCH, kind)
        return dataclasses.replace(c, remat="none", rns=dataclasses.replace(
            c.rns, backend="reference"))

    def rns():
        t0 = time.perf_counter()
        c = plain("rns")
        out["rns"] = _loss_grads(torch, cpu_model(c).requires_grad_(True),
                                 c, batch)
        out["rns_s"] = time.perf_counter() - t0

    def deferred():
        t0 = time.perf_counter()
        d = plain("deferred")
        with torch.no_grad():
            out["deferred"] = M.loss_fn(attach_resident(cpu_model(d), d), d,
                                        batch)[0]
        out["deferred_s"] = time.perf_counter() - t0

    errors = []

    def run(fn):
        try:
            fn()
        except Exception:           # reported through the exit code
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (rns, deferred)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    torch.save(out, TRAIN_CPU_DIR / "out.pt")
    return 0


def _kernel_nodes(graph) -> dict:
    """The RNS kernel nodes of a captured graph, by kernel."""
    nodes: dict = {}
    for name in _graph_kernel_names(graph):
        kind = _kernel_kind(name)
        if kind is not None:
            nodes[kind] = nodes.get(kind, 0) + 1
    return nodes


def _train_path(torch, label: str, cfg, steps: int, launches: dict, *,
                eager: int = 0, resident: bool = False, data=None,
                compare: bool = True, calls: dict | None = None,
                after_eager=None):
    """``steps`` captured steps of ``cfg`` from the seed-0 weights (counts
    from 0 before, read after: the python-counted launches of the warm-up
    and capture plus the graph's kernel nodes times the replays after
    the first), and ``eager`` eager steps from the same weights (timed;
    with ``compare``, held to the captured ones bit for bit).  ``data``:
    anything with ``batch(step)`` (SyntheticLM, or a Trainer's batches
    with their frontend stub).  ``calls``: the eager steps' RNS wrapper
    calls are recorded into it (``_recording``); ``after_eager()`` runs
    once the eager state is off the card, before the captured run.
    Returns (numbers, captured state, TrainStep)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts

    data = data or SyntheticLM(DataConfig(**TRAIN_DATA))
    opt = AdamWConfig(lr=3e-3, warmup_steps=max(10, steps // 20),
                      total_steps=steps)
    dev = torch.device("cuda")
    out = {"steps": steps, "tokens_per_step": TRAIN_DATA["seq_len"]
           * TRAIN_DATA["global_batch"], "grad_accum": cfg.grad_accum,
           "remat": cfg.remat}
    gc.collect()                    # the previous path's state and graph
    torch.cuda.empty_cache()
    eager_state = eager_losses = None
    if eager:
        eager_state = ts.init_train_state(cfg, 0, dev)
        step = ts.make_train_step(cfg, opt, resident_weights=resident,
                                  graphs=False)
        times, eager_losses = [], []
        with (_recording(torch, calls) if calls is not None
              else contextlib.nullcontext()):
            for i in range(eager):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = step(eager_state, data.batch(i))
                eager_losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t0)
        out["step_ms_eager"] = statistics.median(times) * 1e3
        eager_state = _host_state(torch, eager_state) if compare else None
        del step
        gc.collect()
        torch.cuda.empty_cache()
    if after_eager is not None:
        after_eager()
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(cfg, 0, dev)
    step = ts.make_train_step(cfg, opt, resident_weights=resident)
    _reset_launches()
    losses, auxes, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux"]))
        times.append(time.perf_counter() - t0)
        if compare and eager and i + 1 == eager:
            if losses != eager_losses or not _state_equal(torch, state,
                                                          eager_state):
                raise AssertionError(
                    f"[train] {label}: captured steps {losses} differ "
                    f"from eager {eager_losses}")
            out["captured_equals_eager_steps"] = eager
            del eager_state
    counted = _launches()
    nodes = _kernel_nodes(step.program.graph)
    launches[f"train_{label}"] = {
        k: counted[k] + nodes.get(k, 0) * (steps - 1) for k in counted}
    if step.captures != 1:
        raise AssertionError(f"[train] {label}: {step.captures} captures")
    med = statistics.median(times[1:]) * 1e3
    out.update(step_ms_captured=med, first_step_s=times[0],
               tokens_per_s=out["tokens_per_step"] / med * 1e3,
               rns_kernels_per_step=sum(nodes.values()), by_kernel=nodes,
               all_kernel_nodes=len(_graph_kernel_names(step.program.graph)),
               captures=step.captures, losses=losses, aux=auxes,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out, state, step


#: [train]'s CPU check while it runs: the child process and the card's
#: side of the comparison, read by [train_cpu]
_TRAIN_CPU: dict = {}


def phase_train(torch, launches: dict, record: dict):
    """[train] (:func:`_train_paths`) beside the CPU port's step 1 in a
    child process (:func:`_start_train_cpu_check`), which runs on through
    [train_archs] and is read by [train_cpu]; killed if [train] fails."""
    proc = _start_train_cpu_check(torch)
    try:
        results, check = _train_paths(torch, launches, record)
    except BaseException:
        _stop_train_cpu_check(proc)
        raise
    _TRAIN_CPU.update(proc=proc, check=check)
    return results


def phase_train_cpu(torch):
    """[train]'s card step 1 against the CPU port's (the child started
    with [train], waited for here, after [train_archs] ran beside it)."""
    if not _TRAIN_CPU:
        print("  [train] did not start a CPU check")
        return None
    proc, check = _TRAIN_CPU.pop("proc"), _TRAIN_CPU.pop("check")
    return check(_finish_train_cpu_check(torch, proc))


def _train_paths(torch, launches: dict, record: dict):
    """Training at published width (A slice 4a): smollm-135m whole, float
    (20 captured steps, the loss down by 0.3; the first 3 equal 3 eager
    steps bit for bit), per-op rns9 at 16 bits with the RNS backward (the
    first step's loss and gradients on the kernels bit-equal to
    ``backend="reference"`` on the card, the loss within TRAIN_CPU_TOL of
    the CPU port's, ``measure_rns_ops`` = JAX's x 30), the same on
    ``cuda_fused`` (bit-equal to per-op), fused deferred with resident
    weights (B.5 and B.6 forward, the float backward; masters move, the
    optimizer holds no digits); tinyllama-1.1b at depth
    TRAIN_BIG_LAYERS, float and per-op, ``grad_accum=2``; a resumed run bit-equal to an uninterrupted one;
    every distinct B.1-B.6 call of the eager steps bit-equal to its plain
    version, checked and timed.  Returns (results, ``check(cpu_out)``:
    the card's step 1 against the CPU port's, once the child wrote it)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.resident import attach_resident
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    smi = _smi()
    data = SyntheticLM(DataConfig(**TRAIN_DATA))
    batch0 = {"tokens": torch.as_tensor(data.batch(0)["tokens"], device=dev)}
    results, calls = {}, {}

    def report(label, out):
        out["card"] = smi
        results[label] = out
        print(json.dumps({f"train_{label}": out}), flush=True)

    cfg = _train_cfg(TRAIN_ARCH, "rns")
    ref = dataclasses.replace(cfg, rns=dataclasses.replace(
        cfg.rns, backend="reference"))
    dcfg = _train_cfg(TRAIN_ARCH, "deferred")
    model = ts.init_train_state(cfg, 0, dev)["model"]
    masters = torch.load(TRAIN_CPU_DIR / "in.pt")["masters"]
    if not all(torch.equal(p.detach().cpu(), masters[n])
               for n, p in model.named_parameters()):
        raise AssertionError("[train] the CPU check's weights are not the "
                             "seed-0 weights drawn here")
    del masters

    # 1. float: 20 captured steps, the first 3 = 3 eager steps
    out = _train_path(torch, "float", _train_cfg(TRAIN_ARCH, "float"),
                      TRAIN_STEPS, launches, eager=3, data=data)[0]
    drop = out["losses"][0] - out["losses"][-1]
    out["loss_drop"] = drop
    report("float", out)
    if not drop >= TRAIN_LOSS_DROP:
        raise AssertionError(f"[train] float: loss fell {drop} < "
                             f"{TRAIN_LOSS_DROP} in {TRAIN_STEPS} steps")

    # 2.-4. step 1 of per-op rns9, fused and fused deferred resident on
    # the card: the kernels' loss and gradients vs the plain versions on
    # the card, fused vs per-op; op counts vs JAX
    with _recording(torch, calls):
        got = _loss_grads(torch, model, cfg, batch0)
    bad = _differ(torch, got, _loss_grads(torch, model, ref, batch0))
    if bad:
        raise AssertionError(f"[train] rns: kernels vs reference on the "
                             f"card differ at {bad[:3]} ({len(bad)})")
    loss_k, _, grads_k = got
    ops = ts.measure_rns_ops(model, cfg, batch0).as_dict()
    want = {k: v * cfg.n_layers for k, v in JAX_TRAIN_RNS_OPS.items()}
    if ops != want:
        raise AssertionError(f"[train] measure_rns_ops {ops}, JAX x "
                             f"{cfg.n_layers}: {want}")
    fcfg = _train_cfg(TRAIN_ARCH, "fused")
    with _recording(torch, calls):
        bad = _differ(torch, got, _loss_grads(torch, model, fcfg, batch0))
    if bad:
        raise AssertionError(f"[train] fused vs per-op differ at "
                             f"{bad[:3]} ({len(bad)})")
    del got
    attach_resident(model, dcfg)
    with _recording(torch, calls):
        loss_d = _loss_grads(torch, model, dcfg, batch0)[0]
    del model

    # the captured runs of paths 2-4
    out = _train_path(torch, "rns", cfg, 5, launches, eager=1,
                      data=data)[0]
    out.update(kernels_equal_reference=True, measure_rns_ops=ops)
    report("rns", out)
    rns_losses = out["losses"]
    out = _train_path(torch, "fused", fcfg, 3, launches, eager=1,
                      data=data)[0]
    report("fused", out)
    if out["losses"] != rns_losses[:3]:
        raise AssertionError(f"[train] fused losses {out['losses']} != "
                             f"per-op {rns_losses[:3]}")
    out, state = _train_path(torch, "deferred", dcfg, 3, launches,
                             eager=1, resident=True, data=data)[:2]
    init = ts.init_train_state(dcfg, 0, dev)["model"]
    moved = sum(not torch.equal(p, init.get_parameter(n))
                for n, p in state["model"].named_parameters())
    names = set(state["opt"]["m"])
    params = {n for n, _ in state["model"].named_parameters()}
    out.update(masters_moved=moved, opt_state_tensors=len(names))
    report("deferred", out)
    if moved != len(params) or names != params or any(
            n.endswith(("_digits", "_scale")) for n in names):
        raise AssertionError(f"[train] deferred: {moved} of {len(params)} "
                             "masters moved, or digits in the opt state")
    if out["losses"][0] != float(loss_d):
        raise AssertionError(f"[train] deferred: captured step-1 loss "
                             f"{out['losses'][0]} vs eager {float(loss_d)}")
    del state, init
    for label, kernels in TRAIN_KERNELS.items():
        idle = [k for k in kernels if not launches[f"train_{label}"][k]]
        if idle:
            raise AssertionError(f"[train] {label}: {idle} never launched")

    # 5. tinyllama-1.1b at TRAIN_BIG_LAYERS, grad_accum=2: float, per-op
    from repro_torch.configs.base import at_depth

    print(f"  {TRAIN_BIG}: depth {TRAIN_BIG_LAYERS} of "
          f"{_train_cfg(TRAIN_BIG, 'float').n_layers} (full width)")
    for kind in ("float", "rns"):
        big = at_depth(_train_cfg(TRAIN_BIG, kind), TRAIN_BIG_LAYERS)
        out = _train_path(torch, f"tinyllama_{kind}", big, 2, launches,
                          eager=1, compare=False)[0]
        report(f"tinyllama_{kind}", out)
        print(f"  tinyllama {kind}: peak {out['peak_gib']:.2f} GiB on {smi}")
        torch.cuda.empty_cache()

    # 6. resume: 3 steps, a new Trainer restores step 3 and takes step 4
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=4)

    def trainer(d, total, every=3):
        return Trainer(cfg, opt, TrainerConfig(
            total_steps=total, ckpt_every=every, ckpt_dir=str(d),
            log_every=100, async_ckpt=False),
            DataConfig(**TRAIN_DATA), device=dev)

    replayed: dict = {}

    def run(t):
        # the counters see each Trainer's warm-up and capture; its graph's
        # kernel nodes run once a step, the first step's replay counted
        state, hist = t.run()
        for k, n in _kernel_nodes(t.step_fn.program.graph).items():
            replayed[k] = replayed.get(k, 0) + n * (len(hist) - 1)
        return state, hist

    _reset_launches()
    state_a, hist_a = run(trainer(ckdir / "a", 4, every=4))
    run(trainer(ckdir / "b", 3))
    state_b, hist_b = run(trainer(ckdir / "b", 4))
    counted = _launches()
    launches["train_resume"] = {k: counted[k] + replayed.get(k, 0)
                                for k in counted}
    if hist_b != hist_a[3:] or not _state_equal(torch, state_a, state_b):
        raise AssertionError(f"[train] resume: {hist_b} vs {hist_a[3:]}")
    report("resume", {"uninterrupted": hist_a, "resumed_step_4": hist_b,
                      "bit_equal": True})
    del state_a, state_b
    shutil.rmtree(ckdir, ignore_errors=True)

    # 7. every distinct B.1-B.6 call of the eager steps, bit for bit
    for a, n in ((1024, 576), (1024, 1536)):
        x = torch.randn((a, n), device=dev)
        print(f"  contiguous copy of a transposed [{n},{a}] float32 view: "
              f"{_time_ms(torch, lambda x=x: x.T.contiguous(), 20):.5f} ms "
              f"on {smi}")
    phase_kernels(torch, dev, record, calls, launches, main_path_only=True,
                  seen=set(), tag="train ")
    calls.clear()

    def check(cpu_out):
        """The card's step 1 against the CPU port's (``cpu_out``, what the
        child wrote)."""
        loss_c, _, grads_c = cpu_out["rns"]
        gdiff, gwhere = _grad_diff(torch, grads_k, grads_c)
        out = {"rns_loss_card": float(loss_k), "rns_loss_cpu": float(loss_c),
               "rns_loss_diff": abs(float(loss_k) - float(loss_c)),
               "rns_max_grad_diff": gdiff, "rns_max_grad_diff_at": gwhere,
               "rns_cpu_s": cpu_out["rns_s"],
               "deferred_loss_card": float(loss_d),
               "deferred_loss_cpu": float(cpu_out["deferred"]),
               "deferred_loss_diff": abs(float(loss_d)
                                         - float(cpu_out["deferred"])),
               "deferred_cpu_s": cpu_out["deferred_s"]}
        report("cpu", out)
        if not (out["rns_loss_diff"] <= TRAIN_CPU_TOL
                and out["deferred_loss_diff"] <= TRAIN_CPU_TOL):
            raise AssertionError(f"[train] card vs CPU: {out}")
        return out

    return results, check


# ------------------------------------------------------- [train_archs] ----
#: the other families trained at their published widths (A slice 4b):
#: arch -> (decoder depth, encoder depth, routed experts); None keeps the
#: published value.  One full MoE layer does not fit one card at 16
#: bytes a parameter (float32 parameters, gradients, m, v): DeepSeek-V2's
#: 160 routed experts are 3.77 B parameters, Jamba's 16 are 2.82 B
TRAIN_ARCHS = {
    "deepseek-v2-236b": (1, None, 16),
    "jamba-v0.1-52b": (2, None, 4),
    "rwkv6-7b": (2, None, None),
    "whisper-medium": (2, 2, None),
    "paligemma-3b": (4, None, None),
}
#: captured float steps a model (the loss after them below step 1's)
TRAIN_ARCH_STEPS = 10
#: the MoE model that also trains on ``cuda_fused``, with resident
#: deferred shared experts, and resumes from a checkpoint
TRAIN_MOE = "deepseek-v2-236b"


def _train_arch_cfg(arch: str, kind: str):
    """``arch`` at its published width with TRAIN_ARCHS' cuts and
    ``remat="full"``, float or on an RNS path (``_train_cfg``'s kinds).
    Returns (config, {field: "published -> run"})."""
    from repro_torch.configs.base import at_depth, get_config
    from repro_torch.core.rns_matmul import RnsDotConfig

    full = get_config(arch)
    depth, enc, experts = TRAIN_ARCHS[arch]
    cfg, changed = dataclasses.replace(full, remat="full"), {}
    if depth is not None and depth != full.n_layers:
        cfg = at_depth(cfg, depth)
        changed["n_layers"] = f"{full.n_layers} -> {depth}"
    if enc is not None and enc != full.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=enc)
        changed["n_enc_layers"] = f"{full.n_enc_layers} -> {enc}"
    if experts is not None and experts != full.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=experts))
        changed["n_experts"] = (f"{full.moe.n_experts} -> {experts} (top-"
                                f"{full.moe.top_k}, capacity factor "
                                f"{full.moe.capacity_factor} kept)")
    if kind != "float":
        backend = "cuda" if kind == "rns" else "cuda_fused"
        cfg = dataclasses.replace(cfg, rns=RnsDotConfig(
            **TRAIN_RNS, backend=backend, defer=kind == "deferred"),
            rns_targets="mlp")
    return cfg, changed


def _twin_train_cfg(arch: str):
    """``arch``'s smoke twin with ``remat="full"``, per-op rns9 at 16 bits
    on the kernels (the resume's model)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.rns_matmul import RnsDotConfig

    return dataclasses.replace(
        get_config(arch, smoke=True), remat="full",
        rns=RnsDotConfig(**TRAIN_RNS, backend="cuda"), rns_targets="mlp")


def phase_train_archs(torch, launches: dict, record: dict):
    """Training the other families at published width (A slice 4b):
    DeepSeek-V2 (MLA + MoE with shared experts), Jamba (Mamba + dense,
    Mamba + MoE), RWKV-6 (chunked time-mix + channel-mix), whisper-medium
    (encoder-decoder over 1500 stub frames) and paligemma-3b (256 stub
    patches ahead of the tokens), cut as TRAIN_ARCHS says, each config's
    own ``grad_accum`` and ``remat="full"``, [8, 128] SyntheticLM tokens a
    step over 1024 ids with the Trainer's frontend stub, AdamW as the CLI.
    Each model: float, 3 eager steps = the first 3 of 10 captured bit for
    bit and the loss after them below step 1's; per-op rns9 at 16 bits
    with the RNS backward, step 1's loss, aux loss and every gradient on
    the kernels bit-equal to ``backend="reference"`` on the card, 1 eager
    step (its distinct B.1-B.6 calls recorded, then checked against
    their plain versions and timed) = the first of 3 captured.
    DeepSeek-V2 also: ``cuda_fused`` bit-equal to per-op (step 1 and 2
    captured losses), the resident deferred shared experts (B.5, B.6;
    the masters move, the optimizer holds no digits), and a Trainer
    resumed from a checkpoint bit-equal to an uninterrupted run."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.models.resident import resident_profiles
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    smi = _smi()
    results, calls, seen = {}, {}, set()
    ckdir = ROOT / "build" / "train_archs_ckpt"
    t_phase = time.perf_counter()

    def stamp(what):
        print(f"  [+{time.perf_counter() - t_phase:.1f} s] {what}", flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)

    def report(label, out):
        out["card"] = smi
        results[label] = out
        print(json.dumps({f"train_{label}": out}), flush=True)
        print(f"  {label}: step {out['step_ms_captured']:.2f} ms captured "
              f"({out.get('step_ms_eager', float('nan')):.1f} eager), "
              f"{out['tokens_per_s']:.1f} tokens/s, "
              f"{out['all_kernel_nodes']} kernel nodes "
              f"({out['rns_kernels_per_step']} RNS), first step "
              f"{out['first_step_s']:.2f} s, peak {out['peak_gib']:.2f} GiB, "
              f"aux {out['aux'][0]:.6g} on {smi}", flush=True)

    def trainer(cfg, d, total, every=100):
        opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=total)
        return Trainer(cfg, opt, TrainerConfig(
            total_steps=total, ckpt_every=every, ckpt_dir=str(d),
            log_every=100, async_ckpt=False), DataConfig(**dict(
                TRAIN_DATA, vocab=min(TRAIN_DATA["vocab"], cfg.vocab))),
            device=dev)

    class Batches:
        """The Trainer's batches (tokens and the frontend stub)."""

        def __init__(self, cfg):
            self.t = trainer(cfg, ckdir / "data", TRAIN_ARCH_STEPS)

        def batch(self, step):
            return self.t._batch(step)

    for arch in TRAIN_ARCHS:
        short = arch.split("-")[0]
        cfg, changed = _train_arch_cfg(arch, "float")
        n = sum(p.numel() for p in Model(cfg, device="meta").parameters())
        print(f"  {arch}: d_model {cfg.d_model}, {n} parameters, "
              f"grad_accum {cfg.grad_accum}, remat {cfg.remat}; changed "
              f"from the published config: {changed or 'nothing'}",
              flush=True)
        data = Batches(cfg)
        stamp(f"{arch}: float")
        # float: 3 eager = the first 3 of TRAIN_ARCH_STEPS captured
        out = _train_path(torch, f"{short}_float", cfg, TRAIN_ARCH_STEPS,
                          launches, eager=3, data=data)[0]
        out.update(params=n, changed=changed)
        report(f"{short}_float", out)
        if not out["losses"][-1] < out["losses"][0]:
            raise AssertionError(f"[train_archs] {arch} float: loss "
                                 f"{out['losses']} did not fall")
        if (cfg.moe is not None) != (out["aux"][0] > 0):
            raise AssertionError(f"[train_archs] {arch}: aux {out['aux']}")
        # per-op rns9: step 1 on the kernels = the plain versions
        stamp(f"{arch}: rns step 1, kernels vs reference")
        rcfg = _train_arch_cfg(arch, "rns")[0]
        ref = dataclasses.replace(rcfg, rns=dataclasses.replace(
            rcfg.rns, backend="reference"))
        batch0 = {k: torch.as_tensor(v, device=dev)
                  for k, v in data.batch(0).items()}
        model = ts.init_train_state(rcfg, 0, dev)["model"]
        got = _loss_grads(torch, model, rcfg, batch0)
        bad = _differ(torch, got, _loss_grads(torch, model, ref, batch0))
        if bad:
            raise AssertionError(f"[train_archs] {arch} rns: kernels vs "
                                 f"reference on the card differ at "
                                 f"{bad[:5]} ({len(bad)})")
        fused_loss = None
        if arch == TRAIN_MOE:
            fcfg = _train_arch_cfg(arch, "fused")[0]
            bad = _differ(torch, got, _loss_grads(torch, model, fcfg,
                                                  batch0))
            if bad:
                raise AssertionError(f"[train_archs] {arch} fused vs per-op "
                                     f"differ at {bad[:5]}")
            fused_loss = float(got[0])
        print(f"  {arch} rns step 1: loss {float(got[0]):.6f}, aux "
              f"{float(got[1]):.6g}, {len(got[2])} gradients bit-equal to "
              f"the reference on the card"
              + (" and to cuda_fused" if fused_loss is not None else ""),
              flush=True)
        del model, got, batch0

        def check_calls(tag=f"train {short} "):
            phase_kernels(torch, dev, record, calls, launches,
                          main_path_only=True, seen=seen, tag=tag)
            calls.clear()

        stamp(f"{arch}: rns steps")
        out = _train_path(torch, f"{short}_rns", rcfg, 3, launches, eager=1,
                          data=data, calls=calls, after_eager=check_calls)[0]
        out.update(kernels_equal_reference=True)
        report(f"{short}_rns", out)
        idle = [k for k in TRAIN_KERNELS["rns"]
                if not launches[f"train_{short}_rns"][k]]
        if idle:
            raise AssertionError(f"[train_archs] {arch} rns: {idle} never "
                                 "launched")
        if arch == TRAIN_MOE:
            rns_losses = out["losses"]
            stamp(f"{arch}: fused steps")
            out = _train_path(torch, f"{short}_fused", fcfg, 2, launches,
                              eager=1, data=data, calls=calls,
                              after_eager=check_calls)[0]
            report(f"{short}_fused", out)
            if out["losses"] != rns_losses[:2]:
                raise AssertionError(f"[train_archs] {arch} fused losses "
                                     f"{out['losses']} != per-op "
                                     f"{rns_losses[:2]}")
            dcfg = _train_arch_cfg(arch, "deferred")[0]
            stamp(f"{arch}: deferred resident steps")
            out, state = _train_path(torch, f"{short}_deferred", dcfg, 2,
                                     launches, eager=1, resident=True,
                                     data=data, calls=calls,
                                     after_eager=check_calls)[:2]
            init = ts.init_train_state(dcfg, 0, dev)["model"]
            params = {k for k, _ in state["model"].named_parameters()}
            moved = sum(not torch.equal(p, init.get_parameter(k))
                        for k, p in state["model"].named_parameters())
            names = set(state["opt"]["m"])
            out.update(masters_moved=moved, opt_state_tensors=len(names),
                       resident=sorted(resident_profiles(state["model"])))
            report(f"{short}_deferred", out)
            if moved != len(params) or names != params or any(
                    k.endswith(("_digits", "_scale")) for k in names):
                raise AssertionError(f"[train_archs] {arch} deferred: "
                                     f"{moved} of {len(params)} masters "
                                     "moved, or digits in the opt state")
            del state, init
            for label in ("fused", "deferred"):
                idle = [k for k in TRAIN_KERNELS[label]
                        if not launches[f"train_{short}_{label}"][k]]
                if idle:
                    raise AssertionError(f"[train_archs] {arch} {label}: "
                                         f"{idle} never launched")
            # resume, on the MoE model's smoke twin (MLA + MoE with shared
            # experts, per-op on the kernels, its config's grad_accum and
            # remat): a checkpoint of the full-width state is 19.5 GB, and
            # writing, hashing and restoring two took 214 s of run 1 (bit-
            # equal).  A Trainer takes steps 1-2 and checkpoints, a new
            # one restores step 2 and takes step 3: bit-equal to 3
            # uninterrupted captured steps on the same batches
            stamp(f"{arch}: resume (smoke twin)")
            tcfg = dataclasses.replace(
                _twin_train_cfg(arch), grad_accum=rcfg.grad_accum)
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out, state = _train_path(torch, f"{short}_twin", tcfg, 3,
                                     launches, data=Batches(tcfg))[:2]
            twin_losses, twin_host = out["losses"], _host_state(torch, state)
            del state
            replayed: dict = {}

            def run(t, **kw):
                state, hist = t.run(**kw)
                for k, c in _kernel_nodes(t.step_fn.program.graph).items():
                    replayed[k] = replayed.get(k, 0) + c * (len(hist) - 1)
                return state, hist

            _reset_launches()
            run(trainer(tcfg, ckdir / "b", 3), max_steps=2)
            state_b, hist_b = run(trainer(tcfg, ckdir / "b", 3))
            counted = _launches()
            launches[f"train_{short}_resume"] = {
                k: counted[k] + replayed.get(k, 0) for k in counted}
            if hist_b != twin_losses[2:] or not _state_equal(
                    torch, twin_host, state_b):
                raise AssertionError(f"[train_archs] {arch} resume: "
                                     f"{hist_b} vs {twin_losses[2:]}")
            results[f"{short}_resume"] = {
                "config": "smoke twin", "uninterrupted": twin_losses,
                "resumed_step_3": hist_b, "bit_equal": True,
                "s": time.perf_counter() - t0, "card": smi}
            print(json.dumps({f"train_{short}_resume":
                              results[f"{short}_resume"]}), flush=True)
            del state_b, twin_host
            shutil.rmtree(ckdir / "b", ignore_errors=True)
        del data
        gc.collect()
        torch.cuda.empty_cache()
        stamp(f"{arch}: done")
    shutil.rmtree(ckdir, ignore_errors=True)
    return results


# ------------------------------------------------------------------ [dist] --
#: digit sharding (ROADMAP A.11) on the one card: rns9's 9 digits over 3
#: gloo ranks (3 digits a rank); gloo's collectives go through the host,
#: so these serve eagerly (a captured step over gloo raises)
DIST_RANKS = 3
#: each sharded serve: label -> (engine, ServeConfig overrides); the
#: [serve] prompts through ContinuousEngine and BUCKETED_SERVE's 8 x 33
#: through the bucketed Engine (one generate), per-op and with resident
#: weights.  Three ranks share the card over gloo, eagerly, at ~0.65 s a
#: decode step (PERF.md): the traffic is cut to 3 requests and 8 new
#: tokens for the run's time
DIST_SERVE = dict(SERVE, requests=3, new=8)
DIST_BUCKETED = dict(BUCKETED_SERVE, new=8)
DIST_PATHS = {
    "dist_continuous": ("continuous", {}),
    "dist_continuous_resident": ("continuous", {"resident_weights": True}),
    "dist_bucketed": ("bucketed", {}),
    "dist_bucketed_resident": ("bucketed", {"resident_weights": True}),
}
#: the DP x digit train step: 2 data ranks x 3 digit ranks; smollm-135m
#: at full width, its depth cut to this for the run's time; TRAIN_DATA's
#: [8, 128] tokens a step, 4 rows a data rank
DIST_TRAIN_MESH = (2, 3)
DIST_TRAIN_LAYERS = 4
DIST_TRAIN_STEPS = 2
#: AdamW at eps 1e-3, as the step comparisons of the CPU tests run it
#: (ROADMAP C.17: with eps 1e-8 a gradient element near 0 may flip an
#: update's sign from float noise alone)
DIST_ADAM = dict(lr=3e-3, warmup_steps=10, total_steps=DIST_TRAIN_STEPS,
                 eps=1e-3)
#: DP losses against the single card's step, relative
DIST_LOSS_RTOL = 1e-5
#: C.17's bars: a gradient within this share of its tensor's largest
#: element plus this share of the model's largest; a parameter within
#: rtol 1e-4 plus lr / 100 (rns) or 1e-7 (float)
DIST_GRAD_BAR = {"rns": (1e-3, 1e-4), "float": (1e-4, 1e-6)}
DIST_PARAM_BAR = {"rns": (1e-4, DIST_ADAM["lr"] / 100),
                  "float": (1e-4, 1e-7)}
DIST_COMPRESS_STEPS = 3
#: each spawn's deadline (its ranks' start-up included)
DIST_TIMEOUT_S = 420
DIST_DIR = ROOT / "build" / "dist"


def _rank_setup(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _gather_ms(torch, ds, shape, reps: int = 100) -> float:
    """Host time of one ``gather_digits`` of a [K/n, *shape] int32 CUDA
    tensor (every rank of the group calls it)."""
    from repro_torch.distributed import sharding as SH

    x = torch.zeros((3,) + tuple(shape), dtype=torch.int32, device="cuda")
    SH.gather_digits(ds, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        SH.gather_digits(ds, x)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _dist_serve(torch, kind, kw, mesh, graphs=False):
    """One serve of [dist]'s traffic on ``mesh`` (None: one rank):
    (tokens, numbers)."""
    import numpy as np

    from repro_torch.core import dispatch
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.serve import build_model, serve
    from repro_torch.serve.engine import Engine, ServeConfig

    gc.collect()
    torch.cuda.empty_cache()
    if mesh is not None:        # a rank's own peak (the parent keeps its)
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    SH.reset_collective_counts()
    with dispatch.count_ops() as ops:
        if kind == "continuous":
            engine, results, stats = serve(
                "smollm-135m", full=True, rns="rns9", device="cuda",
                graphs=graphs, mesh=mesh, **DIST_SERVE, **kw)
            tokens = _tokens(results)
            decode = [s["step_time_s"] for s in stats["steps"]
                      if not s["admitted"] and s["decoded"]]
            nums = {"tokens_per_s": stats["tokens_per_s"],
                    "ttft_p50_s": stats["ttft_p50_s"],
                    "captures": stats["captures"]}
        else:
            b = DIST_BUCKETED
            model = build_model("smollm-135m", full=True, rns="rns9",
                                device="cuda")
            prompts = np.random.default_rng(0).integers(
                0, model.cfg.vocab, (b["batch"], b["prompt_len"]))
            engine = Engine(model, ServeConfig(
                max_cache=b["prompt_len"] + b["new"] + 8,
                max_new_tokens=b["new"], mesh=mesh, **kw), device="cuda",
                graphs=graphs)
            t0 = time.perf_counter()
            toks = engine.generate(prompts)
            dt = time.perf_counter() - t0
            stats = dict(engine.last_stats, captures=engine.captures())
            tokens = toks.tolist()
            decode = stats["step_time_s"]
            nums = {"tokens_per_s": toks.size / dt,
                    "ttft_s": stats["ttft_s"],
                    "captures": stats["captures"]}
    torch.cuda.synchronize()
    res = engine.model.blocks[0].mlp.resident("wi")
    nums.update(
        decode_step_ms_median=1e3 * statistics.median(decode),
        peak_gib=_gib(torch), launches=_launches(),
        collectives=SH.collective_counts(), normalizes=ops.normalizes,
        backend=stats.get("collective_backend"),
        digit_shards=stats.get("digit_shards"),
        resident_wi_digits=None if res is None else list(res.digits.shape))
    del engine
    return tokens, nums


def _dist_serve_rank(rank, n, record_calls):
    """A rank of the sharded serves (DIST_PATHS, eager, over gloo); rank
    0 records every distinct wrapper call on a digit-group profile and
    holds each to its plain version (``phase_kernels``), timed."""
    import torch

    from repro_torch.core.moduli import DigitGroupProfile, get_profile
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_digit_mesh

    dev = _rank_setup(torch)
    mesh = make_digit_mesh(n)
    out, calls = {"gloo_gather_ms": {}}, {}
    for label, (kind, kw) in DIST_PATHS.items():
        with (_recording(torch, calls) if rank == 0 and record_calls
              else contextlib.nullcontext()):
            out[label] = _dist_serve(torch, kind, kw, mesh)
    ds = SH.DigitSharding(mesh)
    for name, shape in (("decode [3,8,1,1536]", (8, 1, 1536)),
                        ("prefill [3,1,144,1536]", (1, 144, 1536))):
        out["gloo_gather_ms"][name] = _gather_ms(torch, ds, shape)
    if rank == 0 and record_calls:
        group = {k: e for k, e in calls.items() if isinstance(
            get_profile(e["profile"]), DigitGroupProfile)}
        checked: dict = {}
        phase_kernels(torch, dev, checked, group, {}, main_path_only=True,
                      tag="dist ")
        out["record"] = checked
    return out


def _dist_nccl_rank(rank, n):
    """One nccl rank: the sharded ContinuousEngine eager, then captured
    (the digit gather inside the CUDA graphs)."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_digit_mesh

    _rank_setup(torch)
    mesh = make_digit_mesh(n)
    out = {}
    for graphs in (False, True):
        out["captured" if graphs else "eager"] = _dist_serve(
            torch, "continuous", {}, mesh, graphs=graphs)
    out["nccl_gather_ms"] = _gather_ms(torch, SH.DigitSharding(mesh),
                                       (8, 1, 1536))
    return out


def _dist_train_cfg(kind: str):
    from repro_torch.configs.base import at_depth

    return at_depth(_train_cfg(TRAIN_ARCH, kind), DIST_TRAIN_LAYERS)


def _dist_train_state(torch, cfg):
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import init_opt_state

    model = M.init_model(cfg, seed=0, device="cuda").requires_grad_(True)
    return {"model": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def _dist_batches():
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(**TRAIN_DATA))
    return [data.batch(i) for i in range(DIST_TRAIN_STEPS)]


def _dist_train_ref(torch, kind: str) -> dict:
    """The single card's eager step on [dist]'s training twin: step 1's
    gradients, the losses and the parameters after DIST_TRAIN_STEPS."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = _dist_train_cfg(kind)
    state = _dist_train_state(torch, cfg)
    step = make_train_step(cfg, AdamWConfig(**DIST_ADAM), graphs=False)
    batches = _dist_batches()
    _, grads = step.gradients(state, {
        "tokens": torch.as_tensor(batches[0]["tokens"]).long().cuda()})
    losses = []
    t0 = time.perf_counter()
    for b in batches:
        _, m = step(state, b)
        losses.append(float(m["loss"]))
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return {"losses": losses, "step_ms": ms,
            "grads": {k: v.detach().cpu() for k, v in grads.items()},
            "params": {k: v.detach().cpu() for k, v in
                       state["model"].named_parameters()}}


def _dist_train_rank(rank, n, refs):
    """A rank of the DP x digit step (DIST_TRAIN_MESH over gloo, eager):
    per-op rns9 (residues over the model group) and float.  Rank 0 holds
    its gradients and parameters to the single card's step (``refs``:
    files of ``_dist_train_ref``); every rank gives its losses and a hash
    of its parameters, which must be the same on every rank."""
    import hashlib

    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_digit_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_dp_train_step

    _rank_setup(torch)
    mesh = make_digit_mesh(DIST_TRAIN_MESH[1], n_data=DIST_TRAIN_MESH[0])
    out = {}
    for kind, path in refs.items():
        ref = torch.load(path) if rank == 0 else None
        cfg = _dist_train_cfg(kind)
        torch.cuda.reset_peak_memory_stats()
        state = _dist_train_state(torch, cfg)
        step = make_dp_train_step(cfg, AdamWConfig(**DIST_ADAM), mesh,
                                  graphs=False)
        batches = _dist_batches()
        _reset_launches()
        SH.reset_collective_counts()
        _, grads = step.gradients(state, {"tokens": torch.as_tensor(
            batches[0]["tokens"]).long().cuda()})
        torch.cuda.synchronize()
        # the backward's normalizes run on autograd's thread, where
        # count_ops does not see them: the launch counter does
        grad_counts = SH.collective_counts()
        grad_norms = _launches()["rns_normalize"]
        worst = p_worst = None
        if ref is not None:
            top = max(float(g.abs().max()) for g in ref["grads"].values())
            t_rel, m_rel = DIST_GRAD_BAR[kind]
            worst = (0.0, "")
            for k, g in ref["grads"].items():
                g = g.cuda()
                d = float((grads[k] - g).abs().max())
                bar = t_rel * float(g.abs().max()) + m_rel * top
                if d / bar > worst[0]:
                    worst = (d / bar, k)
        del grads
        losses = []
        t0 = time.perf_counter()
        for b in batches:
            _, m = step(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        rtol, atol = DIST_PARAM_BAR[kind]
        digest = hashlib.sha1()
        for k, p in state["model"].named_parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
            if ref is None:
                continue
            want = ref["params"][k].cuda()
            over = float(((p.detach() - want).abs()
                          / (rtol * want.abs() + atol)).max())
            if p_worst is None or over > p_worst[0]:
                p_worst = (over, k)
        out[kind] = {"losses": losses, "step_ms": ms,
                     "params_sha1": digest.hexdigest(),
                     "grad_over_bar": worst, "param_over_bar": p_worst,
                     "gradient_collectives": grad_counts,
                     "gradient_normalizes": grad_norms,
                     "launches": _launches(), "peak_gib": _gib(torch)}
        del state, step, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dist_compress(torch) -> dict:
    """``compress_dci`` on the card: DIST_COMPRESS_STEPS captured steps
    of [dist]'s float twin bit-equal to as many eager ones (losses,
    parameters, m, v and the error feedback)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = _dist_train_cfg("float")
    data = _dist_batches() + _dist_batches()
    runs = {}
    for graphs in (False, True):
        state = _dist_train_state(torch, cfg)
        step = make_train_step(cfg, AdamWConfig(**DIST_ADAM),
                               compress_dci=True, graphs=graphs)
        losses = [float(step(state, data[i % len(data)])[1]["loss"])
                  for i in range(DIST_COMPRESS_STEPS)]
        runs[graphs] = (losses, [t.cpu() for t in _state_list(state)] + [
            e.detach().cpu() for e in state["ef"].values()], step.captures)
        del state, step
        gc.collect()
    (l_e, s_e, _), (l_c, s_c, caps) = runs[False], runs[True]
    if l_e != l_c or caps != 1 or not _state_equal(torch, s_e, s_c):
        raise AssertionError(f"compress_dci: captured {l_c} (captures "
                             f"{caps}) vs eager {l_e}, states equal "
                             f"{_state_equal(torch, s_e, s_c)}")
    return {"losses": l_c, "captures": caps}


#: B.1 and B.2 at the other digit-group sizes (rns8 over 4 or 8 ranks,
#: rns16 over 4 or 8: 2, 1, 4, 2 digits), at smollm-135m's widths: a
#: weight, a decode row and a prefill row
DIST_GROUPS = ("rns8[0:1]", "rns8[6:8]", "rns16[12:16]", "rns16[0:2]")


def _dist_group_grid(torch, record: dict):
    """B.1 and B.2 on DIST_GROUPS, bit-equal to their plain versions and
    timed (``phase_kernels`` on these inputs: not a served path's)."""
    from repro_torch.core.moduli import get_profile

    g = torch.Generator(device="cuda").manual_seed(1)
    calls = {}
    for name in DIST_GROUPS:
        p = get_profile(name)
        for shape in ((576, 1536), (8, 1, 576), (1, 144, 576)):
            x = torch.randn(shape, generator=g, device="cuda")
            s = torch.full((), 127.0 / float(x.abs().max()), device="cuda")
            calls[("rns_convert", name, shape)] = {
                "kernel": "rns_convert", "profile": p, "calls": 0,
                "args": (x, s), "kw": {"bits": 8}}
        b = _residues(torch, p, (576, 1536), g, "cuda").to(torch.int8)
        for rows in ((8, 1), (1, 144)):
            a = _residues(torch, p, rows + (576,), g, "cuda").to(torch.int8)
            calls[("rns_matmul", name, rows)] = {
                "kernel": "rns_matmul", "profile": p, "calls": 0,
                "args": (a, b), "kw": {}}
    checked: dict = {}
    phase_kernels(torch, torch.device("cuda"), checked, calls, {},
                  main_path_only=True, tag="group grid ")
    for kernel, cases in checked.items():
        for c in cases:
            c["calls_in_dist"] = c.pop("calls_in_serve", 0)
            record.setdefault(kernel, []).append(c)


def phase_dist(torch, launches: dict, record: dict):
    """Digit sharding over ranks on the card (A.11): DIST_RANKS gloo
    ranks serve DIST_SERVE and DIST_BUCKETED at full width, per-op and
    resident, eager; the tokens equal the unsharded
    serves' on the card, each rank's resident planes hold 3 of the 9
    digits, one gather a normalize and no other collective, and the
    distinct B.1 / B.2 calls on the digit groups bit-equal to their
    plain versions (timed); one nccl rank's sharded decode captured in
    CUDA graphs gives the eager tokens; the DP x digit step (2 x 3 gloo
    ranks) and float DP against the single card's step; ``compress_dci``
    captured = eager.  Every rank's failure fails the phase."""
    from repro_torch.launch.mesh import spawn

    gc.collect()
    torch.cuda.empty_cache()      # the earlier phases' cached blocks
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    print(f"  [dist] {DIST_RANKS} gloo ranks on one card, rns9 "
          f"({9 // DIST_RANKS} digits a rank); training depth "
          f"{DIST_TRAIN_LAYERS} of {FULL_LAYERS} (full width), mesh "
          f"{DIST_TRAIN_MESH}")
    # the unsharded serves on the card (eager: captured = eager holds)
    want = {kind: _dist_serve(torch, kind, {}, None)[0]
            for kind in ("continuous", "bucketed")}
    refs = {}
    for kind in ("rns", "float"):
        ref = _dist_train_ref(torch, kind)
        print(f"  [dist] single card {kind}: losses {ref['losses']}, "
              f"{ref['step_ms']:.1f} ms a step (eager)")
        refs[kind] = str(DIST_DIR / f"train_{kind}.pt")
        torch.save(ref, refs[kind])
        del ref
    comp = _dist_compress(torch)
    print(f"  [dist] compress_dci: {DIST_COMPRESS_STEPS} captured steps "
          f"= eager, losses {comp['losses']}")
    _dist_group_grid(torch, record)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    serves = spawn(DIST_RANKS, _dist_serve_rank, True, backend="gloo",
                   device="cuda", timeout_s=DIST_TIMEOUT_S)
    serve_s = time.perf_counter() - t0
    bad = []
    for label, (kind, _) in DIST_PATHS.items():
        total: dict = {}
        for rank, out in enumerate(serves):
            toks, nums = out[label]
            if toks != want[kind]:
                bad.append(f"{label} rank {rank}: tokens differ from the "
                           "unsharded serve's")
            col = nums["collectives"]
            if col["gather_digits"] != nums["normalizes"] or \
                    col["all_reduce_sum"] or col["all_reduce_max"]:
                bad.append(f"{label} rank {rank}: collectives {col}, "
                           f"normalizes {nums['normalizes']}")
            if nums["backend"] != "gloo" or \
                    nums["digit_shards"] != DIST_RANKS:
                bad.append(f"{label} rank {rank}: {nums['backend']} x "
                           f"{nums['digit_shards']}")
            shape = nums["resident_wi_digits"]
            if "resident" in label and (shape is None or shape[0] != 3):
                bad.append(f"{label} rank {rank}: resident planes {shape}")
            for k in ("rns_convert", "rns_matmul", "rns_normalize"):
                if not nums["launches"][k]:
                    bad.append(f"{label} rank {rank}: no {k} launch")
            for k, v in nums["launches"].items():
                total[k] = total.get(k, 0) + v
        launches[label] = total
        nums = serves[0][label][1]
        print(json.dumps({label: {
            k: nums[k] for k in ("tokens_per_s", "decode_step_ms_median",
                                 "collectives", "normalizes",
                                 "resident_wi_digits")},
            "peak_gib_by_rank": [o[label][1]["peak_gib"] for o in serves],
            "launches_all_ranks": total}))
    for out in serves:
        print(f"  [dist] gloo gather ms: {out['gloo_gather_ms']}")
    for kernel, cases in serves[0].get("record", {}).items():
        for c in cases:
            c["calls_in_dist"] = c.pop("calls_in_serve", 0)
            record.setdefault(kernel, []).append(c)
    if not serves[0].get("record", {}).get("rns_convert") or \
            not serves[0]["record"].get("rns_matmul"):
        bad.append("no B.1 / B.2 call on a digit group was checked")

    t0 = time.perf_counter()
    nccl, = spawn(1, _dist_nccl_rank, backend="nccl", device="cuda",
                  timeout_s=DIST_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0
    (e_toks, e_nums), (c_toks, c_nums) = nccl["eager"], nccl["captured"]
    if e_toks != c_toks or c_toks != want["continuous"]:
        bad.append("nccl: captured / eager / unsharded tokens differ")
    if c_nums["captures"] != {"decode": 1, "prefill": 1} or \
            c_nums["backend"] != "nccl":
        bad.append(f"nccl: captures {c_nums['captures']}, backend "
                   f"{c_nums['backend']}")
    if not c_nums["collectives"]["gather_digits"]:
        bad.append("nccl: no gather in the captured engine's build")
    launches["dist_nccl"] = e_nums["launches"]
    print(json.dumps({"dist_nccl": {
        "eager": {k: e_nums[k] for k in ("tokens_per_s",
                                         "decode_step_ms_median")},
        "captured": {k: c_nums[k] for k in ("tokens_per_s",
                                            "decode_step_ms_median",
                                            "captures", "peak_gib")},
        "nccl_gather_ms": nccl["nccl_gather_ms"]}}))

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n_train = DIST_TRAIN_MESH[0] * DIST_TRAIN_MESH[1]
    trains = spawn(n_train, _dist_train_rank, refs, backend="gloo",
                   device="cuda", timeout_s=DIST_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    for kind in refs:
        ref = torch.load(refs[kind])
        total = {}
        for rank, out in enumerate(trains):
            o = out[kind]
            if not all(abs(a - b) <= DIST_LOSS_RTOL * abs(b)
                       for a, b in zip(o["losses"], ref["losses"])):
                bad.append(f"dp {kind} rank {rank}: losses {o['losses']} "
                           f"vs {ref['losses']}")
            if o["params_sha1"] != trains[0][kind]["params_sha1"]:
                bad.append(f"dp {kind} rank {rank}: parameters differ from "
                           "rank 0's")
            if rank == 0 and (o["grad_over_bar"][0] > 1
                              or o["param_over_bar"][0] > 1):
                bad.append(f"dp {kind} rank {rank}: gradient "
                           f"{o['grad_over_bar']}, parameter "
                           f"{o['param_over_bar']} (over the bar > 1)")
            col = o["gradient_collectives"]
            if col["all_reduce_sum"] != 1 or \
                    col["gather_digits"] != o["gradient_normalizes"] or \
                    (col["all_reduce_max"] > 0) != (kind == "rns"):
                bad.append(f"dp {kind} rank {rank}: collectives {col}, "
                           f"normalizes {o['gradient_normalizes']}")
            for k, v in o["launches"].items():
                total[k] = total.get(k, 0) + v
        if kind == "rns" and not all(total[k] for k in (
                "rns_convert", "rns_matmul", "rns_normalize")):
            bad.append(f"dp rns: launches {total}")
        launches[f"dist_train_{kind}"] = total
        o = trains[0][kind]
        print(json.dumps({f"dist_train_{kind}": {
            "losses": o["losses"], "single_card_losses": ref["losses"],
            "step_ms_eager": o["step_ms"],
            "single_card_step_ms_eager": ref["step_ms"],
            "grad_over_bar": o["grad_over_bar"],
            "param_over_bar": o["param_over_bar"],
            "gradient_collectives": o["gradient_collectives"],
            "peak_gib_by_rank": [t[kind]["peak_gib"] for t in trains]}}))
    print(f"  [dist] spawns: serve {serve_s:.1f}s, nccl {nccl_s:.1f}s, "
          f"train {train_s:.1f}s")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    if bad:
        raise AssertionError("[dist]:\n" + "\n".join(bad))
    print("[dist] ok")


def _kernel_line(record: dict, launches: dict, tuned: dict) -> dict:
    matmul_src = "src/repro_torch/kernels/rns_matmul/csrc/rns_matmul.cu"
    mma_src = "src/repro_torch/kernels/rns_fused/csrc/rns_fused_mma.cu"
    meta = {
        "rns_convert": ("src/repro_torch/kernels/rns_convert/csrc/"
                        "rns_convert.cu",
                        "src/repro/kernels/rns_convert/kernel.py:38"),
        "rns_matmul": (matmul_src,
                       "src/repro/kernels/rns_matmul/kernel.py:51"),
        "rns_normalize": ("src/repro_torch/kernels/rns_normalize/csrc/"
                          "rns_normalize.cu",
                          "src/repro/kernels/rns_normalize/kernel.py:93"),
        "rns_fused_encode_matmul": (
            mma_src, "src/repro/kernels/rns_fused/kernel.py:82"),
        "rns_fused_matmul_normalize": (
            mma_src, "src/repro/kernels/rns_fused/kernel.py:141"),
        "rns_fused_dot": (mma_src,
                          "src/repro/kernels/rns_fused/kernel.py:194"),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:72"),
    }
    out = []
    for name, (src, replaces) in meta.items():
        cases = record.get(name, [])
        timed = [c for c in cases if "ms" in c]
        if name == "flash_attention":
            # its path is the tuner; [kernels]' launches are comparisons
            head = next((c for c in timed if c["case"].startswith(
                "float32 causal=True q[1,2048,")), {})
            by_path = {path: launches.get(path, {}).get(name, 0)
                       for path in ("tune", "kernels")}
            n = by_path["tune"]
        else:
            # the head of the line: the main-path input called most
            head = max(timed, key=lambda c: c.get("calls_in_serve", 0),
                       default={})
            by_path = {path: run.get(name, 0) for path, run in
                       launches.items()
                       if path.startswith(("serve", "train", "dist"))
                       or path == "fractional"}
            n = sum(by_path.values())
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "launches_by_path": by_path,
            "max_abs_err": max((c["max_abs_err"] for c in cases),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "unfused_ms": head.get("unfused_ms"),
            "case": head.get("case"),
            "blocks_by_bucket": {
                b: {k: t[k] for k in ("default", "tuned", "default_us",
                                      "tuned_us")}
                for b, t in tuned.items() if t["kind"] == name},
            "cases": timed})
    return {"kernels": out}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--train-cpu-check"]:
        return train_cpu_check()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a fresh block table: [serve] and [serve_fused] run on the defaults,
    # [tune] fills it, [serve_tuned] and [kernels] resolve through it
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(TUNE_CACHE)
    TUNE_CACHE.unlink(missing_ok=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} on {torch.cuda.get_device_name(0)}")
    record, launches, calls, failed = {}, {}, {}, []
    untuned, tuned = {}, {}
    # ``--phases a,b``: run only those phases (a debugging aid; the
    # contract's run takes no argument and runs every phase)
    only = None
    for arg in sys.argv[1:]:
        if arg.startswith("--phases="):
            only = set(arg.split("=", 1)[1].split(","))
    for name, fn in [
            ("build", phase_build),
            ("serve", lambda: untuned.__setitem__("serve", phase_serve(
                torch, "serve", launches, calls))),
            ("serve_fused", lambda: untuned.__setitem__(
                "serve_fused", phase_serve(torch, "serve_fused", launches,
                                           calls))),
            ("serve_per_layer", lambda: phase_serve_per_layer(
                torch, launches, calls, untuned)),
            ("serve_chunked", lambda: phase_serve_chunked(
                torch, launches, calls, untuned)),
            ("serve_prefix", lambda: phase_serve_prefix(torch, launches)),
            ("serve_spec", lambda: phase_serve_spec(torch, launches, calls,
                                                    untuned)),
            ("serve_window", lambda: phase_serve_window(torch, launches,
                                                        calls)),
            ("serve_bucketed", lambda: phase_serve_bucketed(torch, launches,
                                                            calls)),
            ("tune", lambda: phase_tune(torch, dev, calls, launches, tuned)),
            ("serve_tuned", lambda: phase_serve_tuned(torch, launches, calls,
                                                      untuned)),
            ("serve_mla", lambda: phase_serve_mla(torch, launches, calls)),
            # the recorded inputs' copies are freed once checked: the
            # largest models come last
            ("kernels", lambda: (phase_kernels(torch, dev, record, calls,
                                               launches), calls.clear())),
            ("identity", lambda: phase_identity(torch)),
            ("fractional", lambda: phase_fractional(torch, dev, record,
                                                    launches)),
            ("serve_archs", lambda: phase_serve_archs(torch, launches,
                                                      record)),
            ("serve_ssm", lambda: phase_serve_ssm(torch, launches, record)),
            ("serve_encdec", lambda: phase_serve_encdec(torch, launches,
                                                        record)),
            ("train", lambda: phase_train(torch, launches, record)),
            ("train_archs", lambda: phase_train_archs(torch, launches,
                                                      record)),
            # [train]'s CPU check, run beside [train_archs]
            ("train_cpu", lambda: phase_train_cpu(torch)),
            # after [train]'s CPU child: the host holds one of them
            ("dist", lambda: phase_dist(torch, launches, record))]:
        if only is not None and name not in only and not (
                name == "train_cpu" and "train" in only):
            continue
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:           # report the phase, go on with the next
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED", flush=True)
        print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)
    if _TRAIN_CPU:                  # [train_cpu] did not run
        _stop_train_cpu_check(_TRAIN_CPU.pop("proc"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    print(f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
          f"on {smi}")
    print(json.dumps(_kernel_line(record, launches, tuned)))
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
