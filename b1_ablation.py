"""Where B1's and B6's time goes at ``precision="default"``: the fused front
end's kernels timed with one stage of their tensor-core design taken out.

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``::

    python3 b1_ablation.py

Each variant is a copy of ``dy4tpu_torch`` under ``_archive/b1_ablation/``
(which ``.gitignore`` lists) whose ``csrc/frontend.cu`` has one stage cut
by a text edit: the RF stage's MMAs, the band bank's and carrier BPF's
MMAs (each replaced by a float add of the fragments' bits, so the loads
stay), the u8 window's copies, the demod's division, the RF tail's sums.
The outputs of a cut variant are wrong by design: it is timed, never
checked.  Every variant is built (all at once), then B1 and B6 at modes 0
and 1 (C=512, u8 rows and state from a seed) are timed alone under
``torch.profiler`` (mean device time of 20 calls), in two rounds, each
variant in a process of its own.  Prints the card's name and power limit,
one line a variant and round, then the numbers as one JSON line.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

C = 512
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "_archive" / "b1_ablation"

# variant -> (text in csrc/frontend.cu, its replacement) edits
CUTS = {
    "full": (),
    "no RF MMA": ((
        "      tc::mma(acc, a, s.fr[32 * kk + lane]);",
        "      acc[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^\n"
        "                                s.fr[32 * kk + lane].x);"),),
    "no band MMA": ((
        "        tc::mma(acc[f], a, s.fb[32 * (f * g.ks_b + kk) + lane]);",
        "        acc[f][0] += __uint_as_float(\n"
        "            a[0] ^ a[3] ^ s.fb[32 * (f * g.ks_b + kk) + lane].x);"), (
        "      tc::mma(acc, a, s.fc[32 * kk + lane]);",
        "      acc[0] += __uint_as_float(a[0] ^ a[3] ^ s.fc[32 * kk + lane].x);"
    )),
    "no window copies": ((
        "      cpa::copy4(buf + j, x + 2 * n);", ""),),
    "no demod division": ((
        "    const float v =\n        rf::fm_demod(s.iq_i[l + 1], "
        "s.iq_q[l + 1], s.iq_i[l], s.iq_q[l]);",
        "    const float v = s.iq_i[l + 1] * s.iq_q[l] - "
        "s.iq_q[l + 1] * s.iq_i[l];"),),
    "no RF tail sums": ((
        "  for (int k = tid; k < 2 * (t1 - t.g0); k += kThreads) {",
        "  for (int k = tid; k < 0; k += kThreads) {"),),
}


def _ms(fn, kernel: str):
    """Mean device milliseconds of ``kernel`` over 20 calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages() if kernel in e.key
                and getattr(e, "device_time_total", 0.0) > 0]
        count = sum(e.count for e in mine)
        if count:
            return sum(e.device_time_total for e in mine) / count / 1e3
    return None


def time_here() -> dict:
    """B1 and B6 at "default", modes 0 and 1, by the dy4tpu_torch in the
    working directory."""
    sys.path.insert(0, ".")
    import torch
    from dy4tpu_torch.config import get_mode
    from dy4tpu_torch.ops import frontend_cuda as fc
    from dy4tpu_torch.pipeline import receiver as rx
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    out = {}
    for mode in (0, 1):
        cfg = get_mode(mode)
        rds = cfg.supports_rds
        p = rx.make_params(cfg, device=dev)
        k, n = cfg.num_taps, cfg.if_per_block
        rnd = lambda *s: 0.1 * torch.randn(  # noqa: E731
            *s, generator=gen, device=dev)
        blk = torch.randint(0, 256, (C, cfg.block_size), generator=gen,
                            device=dev, dtype=torch.uint8)
        st = (rnd(C, 2, k - 1), rnd(C), rnd(C), rnd(C, k - 1), rnd(C, k // 2),
              rnd(C, k - 1), rnd(C, k // 2))
        fargs = (blk, p.rf_coeff, p.bank_coeff, p.rds_carrier_coeff, *st,
                 cfg.rf_decim)
        iargs = (rnd(C, n), rnd(C, n), st[1], st[2], p.bank_coeff,
                 p.rds_carrier_coeff, *st[3:])
        out[f"B1 mode {mode}"] = _ms(
            lambda: fc.fused_frontend_full(*fargs, rds=rds,
                                           precision="default"),
            "frontend_full_kernel")
        out[f"B6 mode {mode}"] = _ms(
            lambda: fc.fused_frontend_if(*iargs, rds=rds,
                                         precision="default"),
            "frontend_if_kernel")
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--time-here":
        print(json.dumps(time_here()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("b1_ablation: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    src = (ROOT / "dy4tpu_torch" / "csrc" / "frontend.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {}
    for k, (name, edits) in enumerate(CUTS.items()):
        d = OUT / f"v{k}"
        shutil.copytree(ROOT / "dy4tpu_torch", d / "dy4tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"b1_ablation: {name}: frontend.cu no "
                                 f"longer holds {old!r}")
            text = text.replace(old, new)
        (d / "dy4tpu_torch" / "csrc" / "frontend.cu").write_text(text)
        dirs[name] = d
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from dy4tpu_torch.runtime import kernels; "
         "kernels.build_all()"], cwd=d) for d in dirs.values()]
    if any(b.wait() for b in builds):
        raise SystemExit("b1_ablation: a variant did not build")
    rows = {name: [] for name in dirs}
    for rnd in (1, 2):
        for name, d in dirs.items():
            got = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--time-here"], cwd=d, capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[-1]
            ms = json.loads(got)
            rows[name].append(ms)
            print(f"round {rnd}, {name}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()) + f" ({smi})",
                flush=True)
    print(json.dumps({"device": smi, "b1_ablation": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
