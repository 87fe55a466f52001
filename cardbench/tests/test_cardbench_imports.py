"""Nothing the benchmark loads is JAX or the JAX package `repro`, compared
by whole top-level names, and the reference loads nothing of the port."""
import ast
import os
import subprocess
import sys

from cardbench import run, spec


def test_names_are_compared_whole():
    found = run.loaded_forbidden(["repro_torch", "repro_torch.models",
                                  "reprox", "repro", "repro.core",
                                  "jax.numpy", "jaxlib", "flax.linen",
                                  "jaxtyping"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                     "repro.core"]


def _loaded(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [spec.ROOT, os.path.join(spec.ROOT, "src")]))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted(n for n in sys.modules))"],
        capture_output=True, text=True, env=env, check=True, cwd=spec.ROOT)
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    mods = _loaded(
        "import cardbench.run, cardbench.calibrate, cardbench.check\n"
        "import cardbench.drivers.train, cardbench.drivers.serve\n"
        "from cardbench import metrics_ctx, spec\n"
        "[spec.metric(m['name']) for m in spec.load_benchmark()"
        "['per_layer']]\n"
        "import repro_torch.launch.train, repro_torch.serve.engine\n")
    assert run.loaded_forbidden(mods) == []
    assert "repro_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded("import cardbench.reference.decoder")
    assert not [m for m in mods if m.split(".")[0] in
                ("repro_torch", "repro", "jax")]
    ref = os.path.join(spec.HERE, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax"), (name, n)
