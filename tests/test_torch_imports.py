"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert {"repro_torch.serving.prefix_cache", "repro_torch.faults.audit",
        "repro_torch.faults.plan", "repro_torch.faults.health",
        "repro_torch.checkpoint.ckpt", "repro_torch.obs.metrics",
        "repro_torch.obs.events", "repro_torch.obs.export",
        "repro_torch.obs.trace", "repro_torch.obs.__main__",
        "repro_torch.faults.chaos", "repro_torch.models.moe",
        "repro_torch.models.encdec", "repro_torch.configs.whisper_small",
        "repro_torch.configs.deepseek_moe_16b",
        "repro_torch.configs.llava_next_mistral_7b"} \
    <= set(names), names       # the port's own copies of pure-Python modules
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every module was imported


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")


def test_cuda_entry_points_raise_without_a_card():
    _no_card()
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = get_config("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg).init_params(torch.Generator())


def test_serving_engine_defaults_to_cuda():
    _no_card()
    from repro_torch.config import AdapterConfig, ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.core import symbiosis
    from repro_torch.core.engine_spec import BankSpec, EngineSpec
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("granite-3-8b").reduced()
    acfg = AdapterConfig(rank=4)
    base, bank = symbiosis.init_system(cfg, acfg, 2, torch.Generator(),
                                       device="cpu")
    spec = EngineSpec(cfg=cfg, banks=(BankSpec("lora", acfg, 2),),
                      serve=ServeConfig(max_seq=32, page_block=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(spec, base, [bank])
    ServingEngine(spec, base, [bank], device="cpu")


def test_non_dense_configs_are_refused():
    """An arch the port does not know is refused; every family has its
    configs now: the MoE, VLM, hybrid, RWKV and encoder-decoder ones."""
    from repro_torch.configs import get_config
    with pytest.raises(KeyError):
        get_config("no-such-model")
    assert [get_config(a).arch for a in ("deepseek-moe-16b", "arctic-480b",
                                         "llava-next-mistral-7b",
                                         "jamba-v0.1-52b", "rwkv6-7b",
                                         "whisper-small")] \
        == ["moe", "moe", "vlm", "hybrid", "rwkv", "encdec"]
