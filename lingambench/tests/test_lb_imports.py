"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port either. Module names are compared by
their top-level name as a whole."""

import subprocess
import sys

import pytest

from lingambench.lib import imports
from lingambench.tests import helpers


@pytest.mark.parametrize("name, bad", [
    ("repro_torch", False), ("repro_torch.core.api", False),
    ("repro", True), ("repro.core", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("jaxtyping", False), ("reprox", False)])
def test_top_level_names_compared_whole(name, bad):
    assert (imports.forbidden([name]) == [name]) is bad


def _loaded_after(modules):
    code = ("import sys\n"
            f"sys.path[:0] = [{str(helpers.CHECKOUT)!r}, "
            f"{str(helpers.SRC)!r}]\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return out.split()


def test_the_harness_loads_no_jax():
    mods = ["lingambench.lib.runner", "lingambench.lib.judge",
            "lingambench.lib.tracing", "lingambench.control"]
    mods += [f"lingambench.drivers.{p.stem}" for p in
             (helpers.BENCH / "drivers").glob("[a-z]*.py")]
    mods += [f"lingambench.metrics.{p.stem}" for p in
             (helpers.BENCH / "metrics").glob("[a-z]*.py")]
    loaded = _loaded_after(mods + ["repro_torch.core",
                                   "repro_torch.serve.engine"])
    assert imports.forbidden(loaded) == []


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(["lingambench.lib.reference",
                            "lingambench.lib.judge",
                            "lingambench.lib.simulate"])
    assert imports.forbidden(loaded, {"repro_torch", "repro", "jax",
                                      "jaxlib", "flax"}) == []


def test_nothing_reads_the_benchmarks_folder():
    for p in helpers.BENCH.rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert "import benchmarks" not in text, p
        assert "from benchmarks" not in text, p
        assert "benchmarks/" not in text, p
