"""launch/attention_profile.py on the CPU: the decode split's cuts still
land on the `// SPLIT` lines of decode_tc<256>, a source without them is
refused, without a card it exits before any build, and an edited or old
source is built from a copy beside the package, whose sources and loaded
library stay in place. Its timings run on the card only."""
import importlib.util
import types
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


@pytest.mark.parametrize("argv", [["--split"], ["--old-bwd", "old_flash_attention_bwd.cu"]])
def test_without_a_card_no_option_builds_anything(monkeypatch, capsys, argv):
    torch = pytest.importorskip("torch")
    ap = _module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ap.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _fake_build(monkeypatch, tmp_path, fail=False):
    """build.py with its compiler and loader replaced: a build records the
    csrc directory it compiled from, a load the one it loaded from."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build" / "repro_torch")
    monkeypatch.setattr(build, "_LIBS", {})

    def build_all(names):
        if fail:
            raise RuntimeError("nvcc failed")
        return {n: (0.0, f"built from {build.CSRC}") for n in names}

    def load(name):
        if name not in build._LIBS:
            build._LIBS[name] = types.SimpleNamespace(csrc=build.CSRC,
                                                      flash_attention_bwd_launch=lambda: 0)
        return build._LIBS[name]

    monkeypatch.setattr(build, "build_all", build_all)
    monkeypatch.setattr(build, "load", load)
    return build


def test_old_bwd_builds_a_copy_and_keeps_the_package_loaded(monkeypatch, tmp_path):
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import flash_attention as fa

    ap = _module()
    build = _fake_build(monkeypatch, tmp_path)
    package = build.CSRC
    old = tmp_path / "old_flash_attention_bwd.cu"
    old.write_text("// the old backward")
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16)
    run, log = ap._old_bwd(torch, build, fa, old, q, k, k, q)
    copy = tmp_path / "build" / "edited" / "old_bwd"
    assert (copy / "flash_attention_bwd.cu").read_text() == "// the old backward"
    assert log == f"built from {copy}"
    assert run.__closure__ is not None and any(
        getattr(c.cell_contents, "csrc", None) == copy for c in run.__closure__)
    assert build.CSRC == package
    assert build._LIBS["flash_attention_bwd"].csrc == package


def test_use_edited_restores_the_package_sources_when_the_build_fails(monkeypatch, tmp_path):
    ap = _module()
    build = _fake_build(monkeypatch, tmp_path, fail=True)
    package = build.CSRC
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ap.pu.use_edited(build, "flash_decode", "// an edited source", "split_loads")
    assert build.CSRC == package
    assert "flash_decode" not in build._LIBS

