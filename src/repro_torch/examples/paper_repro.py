"""Reproduce the paper's evaluation (Figs. 4-7) end to end and print the
validation against every number stated in the text.  PyTorch port of
`examples/paper_repro.py`.

    python -m repro_torch.examples.paper_repro                  # card
    PYTHONPATH=src python -m repro_torch.examples.paper_repro --device cpu

Fig. 6 and Fig. 7 simulate on `--device` (the window kernel on the card);
Figs. 4 and 5 are analytic.
"""
import argparse

from repro_torch.bench import (fig4_extensions, fig5_classification,
                               fig6_single, fig7_multi)
from repro_torch.device import resolve_device


def main(argv=None, print_fn=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print_fn("== Fig 4: fixed-ISA speedups ==")
    rows = fig4_extensions.run()
    for r in rows:
        if r.startswith(("minver", "matmult-int", "wikisort")):
            print_fn("  " + r)
    print_fn("== Fig 5: classification ==")
    print_fn("  " + fig5_classification.run()[-1])
    print_fn("== Fig 6: slot scenarios (speedup vs RV32IMF) ==")
    rows, _ = fig6_single.run(dev)
    for r in rows:
        if r.startswith(("AVERAGE", "#")):
            print_fn("  " + r)
    print_fn("== Fig 7: multi-program (50 pairs) ==")
    rows, _ = fig7_multi.run(device=dev)
    for r in rows:
        if r.startswith(("AVERAGE", "#")):
            print_fn("  " + r)


if __name__ == "__main__":
    main()
