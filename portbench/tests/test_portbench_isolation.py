"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program under test. Module names are
compared by their top-level part, as whole names: ``councilx_torch``
begins with ``councilx`` but is not it."""

import ast
import os
import subprocess
import sys
import types

from portbench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
{imports}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded_after(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=harness.ROOT,
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_traffic_and_metrics_load_no_jax():
    readers = "".join(
        f"harness.reader({m['name']!r})\n"
        for m in harness.manifest()["end_to_end"]
        + harness.manifest()["per_layer"])
    found = loaded_after(
        "from portbench import harness, flops, check, weights, device\n"
        "import portbench.drivers.train_step, portbench.drivers.serve_open"
        "\n" + readers)
    assert not found & set(harness.FORBIDDEN), found & set(harness.FORBIDDEN)
    assert "councilx_torch" in found


def test_reference_loads_nothing_of_the_program():
    found = loaded_after("import portbench.reference.step\n"
                         "import portbench.reference.model")
    assert "councilx_torch" not in found
    assert not found & set(harness.FORBIDDEN)
    ref_dir = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("councilx_torch",) + harness.FORBIDDEN, \
                    (name, mod)


def test_forbidden_modules_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["councilx_torch_probe"] = types.ModuleType("x")
        sys.modules["jaxlibrary"] = types.ModuleType("x")
        assert harness.forbidden_modules() == []
        sys.modules["councilx.ops"] = types.ModuleType("councilx.ops")
        sys.modules["jax"] = types.ModuleType("jax")
        assert harness.forbidden_modules() == ["councilx", "jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_checks_modules_after_the_window():
    """run.py looks at sys.modules after the driver has run and before it
    prints, and exits non-zero naming what it found."""
    src = open(os.path.join(harness.HERE, "run.py")).read()
    drive = src.index("harness.drive(env)")
    guard = src.index("harness.forbidden_modules()")
    printed = src.index("print(json.dumps(line)")
    assert drive < guard < printed
    assert "return 3" in src[guard:printed]
