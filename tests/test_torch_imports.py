"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the JAX package ``repro``."""

import ast
import os
import pathlib

import pytest
from torch_threads import pin_threads, subproc  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py"]

IMPORT_ALL = r"""
import pkgutil, sys, importlib
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # and so does any `import repro...`
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules
               if sys.modules[k] is not None)
print("IMPORTED", len(names))
"""


def test_every_module_imports_without_jax(subproc):
    out = subproc(IMPORT_ALL, devices=1, timeout=300)
    n = int(out.split("IMPORTED")[1].split()[0])
    # every module file of the package (its __init__ counted once)
    n_files = sum(1 for p in PORT.rglob("*.py") if p.name != "__init__.py")
    n_pkgs = sum(1 for p in PORT.rglob("__init__.py")) - 1
    assert n == n_files + n_pkgs
    for mod in SERVING_MODULES + TWO_TIER_MODULES + RUNTIME_MODULES + \
            TP_MODULES + DENSE_CONFIG_MODULES + MOE_MODULES + \
            RECURRENT_MODULES + FRONTEND_MODULES + TUNER_MODULES + \
            FLEET_MODULES:
        assert (PORT / (mod.replace(".", "/") + ".py")).is_file(), mod


#: the serving slice's modules, each imported above without jax
SERVING_MODULES = (
    "kernels.build", "kernels.rmsnorm.ops", "kernels.rmsnorm.kernel",
    "kernels.rmsnorm.ref", "kernels.flash_attention.ops",
    "kernels.flash_attention.kernel", "kernels.flash_attention.ref",
    "kernels.qdot.ops", "kernels.qdot.kernel", "kernels.qdot.ref",
    "serve.kvcache", "serve.sampling", "serve.engine", "serve.scheduler",
    "launch.serve")

#: the two-tier slice's modules (the numpy side and the hierarchy), each
#: imported above without jax
TWO_TIER_MODULES = (
    "core.simulate", "core.traffic", "topology.presets", "topology.cost",
    "topology.table", "kernels.collectives.plan", "collectives.stacked",
    "collectives.api", "train.step", "launch.train", "launch.cell")

#: the checkpoint, runtime, measured-table and obs slice's modules, each
#: imported above without jax
RUNTIME_MODULES = (
    "obs.metrics", "obs.collect", "obs.timeline", "tuner.trace",
    "topology.table", "collectives.api", "train.checkpoint", "train.data",
    "train.runtime", "train.step", "interop", "serve.engine",
    "serve.scheduler", "launch.train")


#: the tensor-parallel slice's modules, each imported above without jax
TP_MODULES = (
    "models.sharding", "models.layers", "models.transformer",
    "collectives.stacked", "train.zero", "train.buckets", "train.step",
    "interop", "launch.train", "launch.cell", "launch.profile_step")


#: the dense configs' slice: the three config copies, each imported above
#: without jax
DENSE_CONFIG_MODULES = (
    "configs.gemma3_4b", "configs.gemma_7b", "configs.qwen3_32b",
    "configs.base", "launch.cell", "launch.profile_serve")


#: the MoE slice: the block, its two config copies and the modules it
#: changed, each imported above without jax
MOE_MODULES = (
    "models.moe", "configs.mixtral_8x7b", "configs.phi35_moe",
    "models.transformer", "serve.engine", "launch.cell",
    "launch.profile_step")


#: the recurrent slice: the blocks, the two config copies and the modules
#: it changed, each imported above without jax
RECURRENT_MODULES = (
    "models.ssm", "configs.xlstm_125m", "configs.zamba2_2p7b",
    "models.transformer", "interop", "train.step", "launch.serve",
    "launch.cell", "launch.profile_step", "launch.profile_serve",
    "kernels.flash_attention.kernel")


#: the frontend slice: the two config copies, each imported above without
#: jax
FRONTEND_MODULES = (
    "configs.musicgen_medium", "configs.pixtral_12b", "configs.base",
    "models.layers", "models.transformer", "launch.serve", "launch.cell")


#: the measurement plane's slice: the probe, the store, the refresh, the
#: drift store and the two CLIs, each imported above without jax
TUNER_MODULES = (
    "tuner.probe", "tuner.store", "tuner.refresh", "tuner.trace",
    "obs.drift", "topology.table", "launch.tune", "launch.report")


#: the fleet and resilience slice: the two packages, their modules and
#: the fleet CLI, each imported above without jax
FLEET_MODULES = (
    "fleet.__init__", "fleet.feedback", "fleet.router", "fleet.placement",
    "fleet.replica", "fleet.fleet", "resilience.__init__",
    "resilience.chaos", "resilience.fakes", "resilience.supervisor",
    "resilience.elastic", "launch.fleet", "topology.cost")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_repro_imports(path):
    src = (ROOT / path).read_text()
    bad = [m for m in _imports(ast.parse(src))
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (path, bad)
    assert os.path.getsize(ROOT / path) > 0
