"""Port vs reference: the ten dump/pack CLIs.

Each tool of ``mt_renderer_tpu_torch.cli`` runs with the same arguments
as its ``mt_renderer_tpu.cli`` original, each on its own
``write_fixture_tree`` tree (the two trees are byte-equal) and with the
tree as the working directory, so the arguments and the printed paths
are the same relative paths. Tolerance: none. Standard output is equal,
and every file a tool writes or deletes leaves the two trees byte-equal:
the ``arctool`` unpack/pack round trip, the ``gmdtool`` dump/rebuild,
``unpackall`` with and without ``--delete`` and ``makefixtures``' own
tree."""

import importlib
from pathlib import Path

import pytest

from mt_renderer_tpu import fixtures as jfix
from mt_renderer_tpu_torch import fixtures as tfix
from torch_threads import one_thread  # noqa: F401

PACKAGES = ("mt_renderer_tpu", "mt_renderer_tpu_torch")


def tree_bytes(root: Path) -> dict:
    """Every file under ``root`` → its bytes, by relative path."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture
def roots(tmp_path):
    """Two fixture trees, one written by each package's
    ``write_fixture_tree``."""
    out = {}
    for pkg, fx in zip(PACKAGES, (jfix, tfix)):
        root = tmp_path / pkg
        fx.write_fixture_tree(root)
        out[pkg] = root
    assert tree_bytes(out[PACKAGES[0]]) == tree_bytes(out[PACKAGES[1]])
    return out


def run_both(roots, capsys, monkeypatch, tool: str, *argvs) -> list:
    """Run ``tool`` of each package on its own tree with each argv in
    turn; returns [reference stdout, port stdout] (every argv's output
    joined)."""
    outs = []
    for pkg in PACKAGES:
        monkeypatch.chdir(roots[pkg])
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        capsys.readouterr()
        for argv in argvs:
            main(list(argv))
        outs.append(capsys.readouterr().out)
    assert outs[0], f"{tool} printed nothing"
    return outs


@pytest.mark.parametrize("tool,argv", [
    ("mtdeserializer", ["chara/fixture_character.chr"]),
    ("mtdeserializer", ["chara/fixture_character_skinned.chr"]),
    ("materialinfo", [".", "model/fixture_cube"]),
    ("materialinfo", [".", "fixture_scene:model\\fixture_cube"]),
    ("schedulerdump", ["motion/fixture_timeline.sdl"]),
    ("schedulerdump", ["motion/fixture_bones.sdl"]),
    ("shaderdump", ["custom_shaders/CustomShaderPackage.mfx"]),
    ("shaderpackagedump", [".", "custom_shaders/CustomShaderPackage"]),
    ("gmdtool", ["dump", "gui/fixture_messages.gmd"]),
    ("scriptparse", ["gui/fixture_messages.gmd"]),
    ("scriptparse", ["gui/fixture_messages.gmd", "--name-gmd",
                     "gui/fixture_messages.gmd"]),
])
def test_dump_tool_prints_like_jax(roots, capsys, monkeypatch, tool, argv):
    ref, port = run_both(roots, capsys, monkeypatch, tool, argv)
    assert port == ref


def test_arctool_round_trip_like_jax(roots, capsys, monkeypatch):
    ref, port = run_both(
        roots, capsys, monkeypatch, "arctool",
        ["unpack", "fixture_scene.arc", "-o", "unpacked"],
        ["pack", "unpacked", "-o", "repacked.arc"],
        ["pack", "unpacked"])
    assert port == ref
    assert "unpacked 8 resources to unpacked" in port
    trees = [tree_bytes(roots[p]) for p in PACKAGES]
    assert trees[1] == trees[0]
    assert trees[1]["repacked.arc"] == trees[1]["unpacked.arc"]


def test_gmdtool_round_trip_like_jax(roots, capsys, monkeypatch):
    dumped = run_both(roots, capsys, monkeypatch, "gmdtool",
                      ["dump", "gui/fixture_messages.gmd"])
    assert dumped[1] == dumped[0]
    for pkg in PACKAGES:
        (roots[pkg] / "m.json").write_text(dumped[0])
    ref, port = run_both(roots, capsys, monkeypatch, "gmdtool",
                         ["rebuild", "m.json", "-o", "re.gmd"])
    assert port == ref
    got = [(roots[p] / "re.gmd").read_bytes() for p in PACKAGES]
    assert got[1] == got[0] == tfix.build_gmd()


@pytest.mark.parametrize("delete", [False, True])
def test_unpackall_like_jax(roots, capsys, monkeypatch, delete):
    argv = ["."] + (["--delete"] if delete else [])
    ref, port = run_both(roots, capsys, monkeypatch, "unpackall", argv)
    assert port == ref
    trees = [tree_bytes(roots[p]) for p in PACKAGES]
    assert trees[1] == trees[0]
    assert ("fixture_scene.arc" in trees[1]) != delete
    assert "fixture_scene/info.json" in trees[1]


def test_makefixtures_like_jax(roots, capsys, monkeypatch):
    ref, port = run_both(roots, capsys, monkeypatch, "makefixtures", ["fx"])
    assert port == ref
    got = [tree_bytes(roots[p] / "fx") for p in PACKAGES]
    assert got[1] == got[0]
    assert "fixture_scene.arc" in got[1]


def test_unpackall_refuses_to_overwrite(roots, capsys, monkeypatch):
    """Both refuse an existing output directory, with the same message."""
    errors = []
    for pkg in PACKAGES:
        monkeypatch.chdir(roots[pkg])
        (roots[pkg] / "fixture_scene").mkdir()
        main = importlib.import_module(f"{pkg}.cli.unpackall").main
        with pytest.raises(SystemExit) as exc:
            main(["."])
        errors.append(str(exc.value))
    assert errors[1] == errors[0]


def help_without_description(text: str) -> str:
    """An argparse help text without its description (the usage and the
    argument sections): the tools' docstrings cite the reference's
    sources by other paths."""
    lines = text.splitlines()
    usage = lines[:lines.index("")]
    start = next(i for i, ln in enumerate(lines)
                 if ln in ("positional arguments:", "options:"))
    return "\n".join(usage + lines[start:])


@pytest.mark.parametrize("tool", [
    "makefixtures", "arctool", "unpackall", "gmdtool", "mtdeserializer",
    "materialinfo", "schedulerdump", "shaderdump", "shaderpackagedump",
    "scriptparse"])
def test_tool_takes_the_reference_arguments(capsys, tool):
    """Each tool's ``--help`` (usage and arguments) equals the
    reference's: the same argparse interface."""
    helps = []
    for pkg in PACKAGES:
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        with pytest.raises(SystemExit) as exc:
            main(["--help"])
        assert exc.value.code == 0
        helps.append(help_without_description(capsys.readouterr().out))
    assert helps[1] == helps[0]
    assert helps[1].startswith(f"usage: {tool} ")
