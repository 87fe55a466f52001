"""Fig. 5 — benchmark classification by ("M", "F") speedups over RV32I.

Validates the paper's class structure: 5 improved-by-both, 8 M-only,
9 insensitive, and no F-only class.  Analytic (no device work); port of the
JAX package's `benchmarks/fig5_classification.py`.
"""
from __future__ import annotations

from repro_torch.core import isa, simulator, traces


def run() -> list[str]:
    rows = ["benchmark,speedup_M,speedup_F,class"]
    counts = {traces.FM_CLASS: 0, traces.M_CLASS: 0, traces.INSENSITIVE: 0}
    for name, bench in traces.BENCHES.items():
        mix = traces.mix_of(name)
        s_m = (simulator.analytic_cpi(mix, isa.RV32I) /
               simulator.analytic_cpi(mix, isa.RV32IM))
        s_f = (simulator.analytic_cpi(mix, isa.RV32I) /
               simulator.analytic_cpi(mix, isa.RV32IF))
        counts[bench.cls] += 1
        rows.append(f"{name},{s_m:.2f},{s_f:.2f},{bench.cls}")
    rows.append(f"# classes: FM={counts[traces.FM_CLASS]} "
                f"M={counts[traces.M_CLASS]} "
                f"insensitive={counts[traces.INSENSITIVE]} "
                f"(paper: 5/8/9)")
    return rows


def main(print_fn=print):
    for row in run():
        print_fn(row)


if __name__ == "__main__":
    main()
