"""launch/vlm_decode_profile.py on the CPU: without a card it exits before
it builds the model. Its timings run on the card only."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _module():
    spec = importlib.util.spec_from_file_location(
        "vlm_decode_profile", ROOT / "src/repro_torch/launch/vlm_decode_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_without_a_card_it_builds_nothing(monkeypatch, capsys):
    torch = pytest.importorskip("torch")
    vp = _module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert vp.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_its_config_is_phase_11s():
    from repro_torch.configs import registry

    vp = _module()
    cfg = registry.get_config(vp.ARCH)
    assert cfg.family == "vlm" and cfg.prefix_len == 256 and cfg.resolved_head_dim == 256
    assert (vp.BATCH, vp.PROMPT, vp.STEPS) == (8, 4096, 64)
