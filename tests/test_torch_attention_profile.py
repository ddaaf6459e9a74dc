"""launch/attention_profile.py on the CPU: the decode split's cuts still
land on the `// SPLIT` lines of decode_tc<256>, a source without them is
refused, and without a card it exits before any build. Its timings run
on the card only."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"


def _module():
    spec = importlib.util.spec_from_file_location(
        "attention_profile", ROOT / "src/repro_torch/launch/attention_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["loads", "no_combine"])
def test_split_cuts_land_in_decode_tc256(kind):
    ap = _module()
    src = (CSRC / "flash_decode.cu").read_text()
    cut = ap._cut_source(src, kind)
    spec = src.index("decode_tc<256>(")  # the hd 256 specialisation's body
    assert src[:spec] == cut[:spec]
    for marker, stmt in ap.SPLIT_MARKERS[kind]:
        assert cut.index(marker) > spec
        assert f"{marker}\n    {stmt}" in cut


@pytest.mark.parametrize("kind", ["loads", "no_combine"])
def test_split_refuses_a_source_without_its_markers(kind):
    ap = _module()
    src = (CSRC / "flash_decode.cu").read_text()
    for marker, _ in ap.SPLIT_MARKERS[kind]:
        with pytest.raises(SystemExit, match="not found once"):
            ap._cut_source(src.replace(marker, "// cut"), kind)


def test_without_a_card_it_builds_nothing(monkeypatch, capsys):
    torch = pytest.importorskip("torch")
    ap = _module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ap.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
