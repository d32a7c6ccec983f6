"""The paper's own demo (Fig. 3): the Mandelbrot set in fractional RNS.

Complex arithmetic runs entirely on residues through Olsen's fractional
RNS (``core/fractional.py``), and so does the escape test ``|z|^2 >= 4``:
on the raw M_f**2-scaled sum, in residue.  One iteration is one step
program (``serve/graphs.py``): captured once in a CUDA graph and
replayed every iteration on the card, the counterpart of the JAX demo's
``jax.jit`` of one iteration; ``--eager`` runs it without the graph.
The arithmetic is exact integers, so the card, eager or captured, and
the CPU give the same escape counts.

    PYTHONPATH=src python -m repro_torch.launch.mandelbrot [--deep] [--eager]
        [--device cpu] [--width 100 --height 32 --iters 48]

``--deep`` first runs the precision proof beyond float64 on a 24-digit
profile with 69 fractional bits: two values of c 1e-19 apart, one
float64 number, encoded exactly on the host, whose orbits differ after
30 iterations.  It is plain tensor ops, as in the JAX demo.
"""

from __future__ import annotations

import argparse
import math
import time
from fractions import Fraction

import numpy as np
import torch

from repro_torch.core import fractional as fr
from repro_torch.core.moduli import RnsProfile, get_profile, \
    greedy_coprime_moduli
from repro_torch.serve.graphs import StepProgram, build_programs

__all__ = ["CHARS", "view", "mandelbrot_step", "MandelbrotRender",
           "render", "escape_f64", "deep_profile", "deep_precision_proof",
           "ascii_art", "main"]

CHARS = " .:-=+*#%@"
RENDER_PROFILE = "rns12"        # an M_f (~2**21) the float encode takes
#: a frame of at most this many pixels iterates on one CPU thread: its
#: digit planes are so small that an op's fork and join of intra-op
#: threads cost more than they save, and on a loaded host the threads
#: wait on each other for every one of the step's ~90 ops
CPU_ONE_THREAD_PIXELS = 1 << 14


def view(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """(cr, ci) float64 [height, width]: the JAX demo's window
    [-2.2, 0.8] x [-1.2, 1.2]."""
    xs = np.linspace(-2.2, 0.8, width)
    ys = np.linspace(-1.2, 1.2, height)
    return (np.repeat(xs[None, :], height, 0),
            np.repeat(ys[:, None], width, 1))


def mandelbrot_step(p, iters: int, zr, zi, cr, ci, esc, it):
    """One iteration z <- z^2 + c in place on fractional residues, and
    ``esc`` (iterations until |z|^2 >= 4, ``iters`` if never) updated
    from the step counter ``it`` (an int32 tensor on the device, raised
    by one).  Each term pays one slow normalization."""
    rr = fr.fr_mul_raw(p, zr, zr)       # PAC products at scale M_f**2
    ii = fr.fr_mul_raw(p, zi, zi)
    ri = fr.fr_mul_raw(p, zr, zi)
    escaped = fr.fr_ge_const(p, fr.fr_add(p, rr, ii), 4.0, raw=True)
    esc.copy_(torch.where((esc == iters) & escaped, it, esc))
    zr.copy_(fr.fr_add(p, fr.fr_normalize(p, fr.fr_sub(p, rr, ii)), cr))
    zi.copy_(fr.fr_add(p, fr.fr_normalize(p, fr.fr_add(p, ri, ri)), ci))
    it.add_(1)
    return esc


class MandelbrotRender:
    """The demo's state on ``device`` and its one-iteration step
    program: on the card captured at construction (``graphs=True``),
    else run eagerly.  :meth:`run` renders from z = 0."""

    def __init__(self, profile, cr: np.ndarray, ci: np.ndarray, iters: int,
                 *, device="cuda", graphs: bool = True):
        self.profile = p = get_profile(profile)
        self.iters = iters
        self.device = dev = torch.device(device)
        shape = tuple(cr.shape)
        self.inputs = {
            "zr": torch.zeros((p.n_digits,) + shape, dtype=torch.int32,
                              device=dev),
            "zi": torch.zeros((p.n_digits,) + shape, dtype=torch.int32,
                              device=dev),
            "cr": fr.fr_encode(p, torch.as_tensor(
                np.asarray(cr, np.float32), device=dev)),
            "ci": fr.fr_encode(p, torch.as_tensor(
                np.asarray(ci, np.float32), device=dev)),
            "esc": torch.full(shape, iters, dtype=torch.int32, device=dev),
            "it": torch.zeros((), dtype=torch.int32, device=dev)}
        self.program = StepProgram(
            "mandelbrot_step",
            lambda **s: mandelbrot_step(p, iters, **s), self.inputs)
        build_programs([self.program], dev, graphs=graphs)

    @property
    def captures(self) -> int:
        return self.program.captures

    def _reset(self):
        """z = 0, no escapes, step 0 (in place: the graph keeps the
        addresses it was captured with; the warm-up moved the state)."""
        for name in ("zr", "zi", "it"):
            self.inputs[name].zero_()
        self.inputs["esc"].fill_(self.iters)

    def run(self) -> np.ndarray:
        """All ``iters`` iterations from z = 0; the escape counts.  On the
        CPU a frame of at most CPU_ONE_THREAD_PIXELS pixels runs on one
        intra-op thread (the setting is restored after)."""
        self._reset()
        threads = torch.get_num_threads()
        one = (self.device.type == "cpu"
               and self.inputs["esc"].numel() <= CPU_ONE_THREAD_PIXELS)
        if one:
            torch.set_num_threads(1)
        try:
            for _ in range(self.iters):
                self.program.run()
        finally:
            if one:
                torch.set_num_threads(threads)
        return self.inputs["esc"].cpu().numpy()


def render(profile, cr, ci, iters: int, *, device="cuda",
           graphs: bool = True) -> tuple[np.ndarray, dict]:
    """Escape counts [height, width] int32 and {seconds (the iterations
    alone, synchronized), build_s, captures, pixel_iters_per_s}."""
    t0 = time.perf_counter()
    r = MandelbrotRender(profile, cr, ci, iters, device=device,
                         graphs=graphs)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    t1 = time.perf_counter()
    esc = r.run()                   # .cpu() waits for the card
    dt = time.perf_counter() - t1
    return esc, {"seconds": dt, "build_s": t1 - t0, "captures": r.captures,
                 "pixel_iters_per_s": esc.size * iters / dt}


def escape_f64(cr, ci, iters: int, *, device="cpu") -> np.ndarray:
    """The same iteration in float64 (not the port: the yardstick the
    JAX demo compares with)."""
    cr = torch.as_tensor(np.asarray(cr, np.float64), device=device)
    ci = torch.as_tensor(np.asarray(ci, np.float64), device=device)
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    esc = torch.full(cr.shape, iters, dtype=torch.int64, device=device)
    for it in range(iters):
        esc = torch.where((esc == iters) & (zr * zr + zi * zi >= 4.0), it,
                          esc)
        zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
    return esc.cpu().numpy()


def deep_profile() -> RnsProfile:
    """24 moduli <= 128, the first 10 fractional: M_f ~ 2**69."""
    return RnsProfile("rns24_deep", greedy_coprime_moduli(128, 24), 10)


def deep_precision_proof(device="cuda", iters: int = 30) -> dict:
    """Two values of c 1e-19 apart (one float64 number) iterated
    ``iters`` times on ``device``, encoded exactly on the host (M_f is
    past the float encode's range).  Returns {f64_equal, diff (the
    orbits' exact difference in Re z, a Fraction), frac_bits}."""
    deep = deep_profile()
    dev = torch.device(device)
    c0 = Fraction(-743643887037151, 10 ** 15)   # a deep-zoom neighbourhood
    cs = [c0, c0 + Fraction(1, 10 ** 19)]
    ci_frac = Fraction(1318259042053300, 10 ** 16)

    def enc(vals):
        return torch.as_tensor(fr.fr_encode_exact(
            deep, np.asarray(vals, dtype=object)), device=dev)

    cr, ci = enc(cs), enc([ci_frac, ci_frac])
    zr, zi = enc([Fraction(0)] * 2), enc([Fraction(0)] * 2)
    for _ in range(iters):
        rr = fr.fr_mul_raw(deep, zr, zr)
        ii = fr.fr_mul_raw(deep, zi, zi)
        ri = fr.fr_mul_raw(deep, zr, zi)
        zr = fr.fr_add(deep, fr.fr_normalize(deep, fr.fr_sub(deep, rr, ii)),
                       cr)
        zi = fr.fr_add(deep, fr.fr_normalize(deep, fr.fr_add(deep, ri, ri)),
                       ci)
    diff = fr.fr_decode_exact(deep, fr.fr_sub(deep, zr[:, 0:1],
                                              zr[:, 1:2]))[0]
    return {"f64_equal": float(cs[0]) == float(cs[1]), "diff": diff,
            "frac_bits": math.log2(deep.M_f), "digits": deep.n_digits,
            "range_bits": deep.range_bits}


def ascii_art(esc: np.ndarray, iters: int) -> str:
    return "\n".join("".join(CHARS[min(int(v) * len(CHARS) // iters,
                                       len(CHARS) - 1)] for v in row)
                     for row in esc)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=100)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--deep", action="store_true",
                    help="first the 69-fractional-bit precision proof "
                         "beyond float64")
    ap.add_argument("--eager", action="store_true",
                    help="run each iteration eagerly, without the graph")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.deep:
        d = deep_precision_proof(args.device)
        print(f"profile rns24_deep: {d['digits']} digit slices, "
              f"{d['range_bits']:.1f}-bit register, {d['frac_bits']:.1f} "
              "fractional bits (float64 mantissa: 53)")
        print(f"  c1 - c0 = 1e-19;  float64(c1) == float64(c0): "
              f"{d['f64_equal']}")
        print(f"  after 30 RNS iterations the two orbits differ by "
              f"{float(d['diff']):.3e} (exact residue arithmetic); float64 "
              "cannot distinguish the two c values at all\n")
    p = get_profile(RENDER_PROFILE)
    print(f"profile {p.name}: {p.n_digits} digit slices, M_f = {p.M_f} "
          f"(~{math.log2(p.M_f):.1f} fractional bits)")
    cr, ci = view(args.width, args.height)
    esc, st = render(p, cr, ci, args.iters, device=args.device,
                     graphs=not args.eager)
    print(ascii_art(esc, args.iters))
    print(f"\n{esc.size} pixels x {args.iters} iters of fractional RNS in "
          f"{st['seconds']:.3f}s on {args.device} "
          f"({st['pixel_iters_per_s']:.0f} pixel-iterations/s; "
          f"captures {st['captures']})")
    agree = float(np.mean(escape_f64(cr, ci, args.iters,
                                     device=args.device) == esc))
    print(f"escape-iteration agreement with float64: {agree:.3f} "
          "(boundary pixels differ by quantization)")


if __name__ == "__main__":
    main()
