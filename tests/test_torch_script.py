"""Port vs reference: GMD script-tag analysis (``formats/script.py``),
its opcode table, the ``scriptparse`` CLI and ``formats/gui.py``.

The cases of ``tests/test_script.py`` (tokenizer, opcode lookups, the
cross-resource resolution) and seeded random messages go through both
packages. Tolerance: none; tokens, parsed tags, resolutions and the
CLI's output are equal, and ``script_opcodes.json`` is byte-equal."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from mt_renderer_tpu.formats import gmd as jgmd
from mt_renderer_tpu.formats import gui as jgui
from mt_renderer_tpu.formats import script as jscript
from mt_renderer_tpu.formats import xfs as jxfs
from mt_renderer_tpu_torch.formats import gmd as tgmd
from mt_renderer_tpu_torch.formats import gui as tgui
from mt_renderer_tpu_torch.formats import script as tscript
from mt_renderer_tpu_torch.formats import xfs as txfs
from torch_threads import one_thread  # noqa: F401

MESSAGES = [
    "Hello <E3 10>world<E1>",
    "x<E4 1",
    "no tags here",
    "",
    "<E263 5 1>",
    "<ICON 3>text<>",
    "a > b < c",
    "<<E1>>",
    "<E12a 4><E 4><E0012 7 8>",
    "<E261 1><E263 7 0><E99999 2>",
]


def name_gmd(gmd):
    return gmd.GuiMessageFile(
        language_id=0, package_name="names", update_time=0,
        messages=[gmd.GuiMessage("NAME_0", "Ryunosuke"),
                  gmd.GuiMessage("NAME_1", "Susato")])


def movie_table(xfs):
    """The movie table of ``tests/test_script.py``: generic app-table
    classes, a ``list`` of entries with a ``path`` string."""
    entry_spec = xfs.ClassSpec("nGO::sAppTable::cIdScenario", [
        xfs.PropSpec("path", xfs.PropType.string, attr=0)])
    table_spec = xfs.ClassSpec("nGO::sAppTable", [
        xfs.PropSpec("list", xfs.PropType.class_, attr=0)])
    root = ("nGO::sAppTable", {"list": [
        ("nGO::sAppTable::cIdScenario", {"path": ["movie\\op.wmv"]}),
        ("nGO::sAppTable::cIdScenario", {"path": ["movie\\ed.wmv"]})]})
    return xfs.serialize(root, [table_spec, entry_spec])


def contexts():
    """(reference, port) script contexts with the name GMD and the movie
    table, each built by its own package; the table's bytes are equal."""
    blobs = [movie_table(x) for x in (jxfs, txfs)]
    assert blobs[0] == blobs[1]
    return (jscript.ScriptContext(name_gmd=name_gmd(jgmd),
                                  movie_table=jxfs.deserialize(blobs[0])),
            tscript.ScriptContext(name_gmd=name_gmd(tgmd),
                                  movie_table=txfs.deserialize(blobs[1])))


def analyse(script, message, ctx=None):
    """Every token of ``message`` and, for tags, its parse, as plain
    tuples."""
    out = []
    for tok in script.tokenize(message):
        row = (tok.is_tag, tok.text)
        if tok.is_tag:
            row += (tuple(tok.tag_parts),
                    dataclasses.astuple(script.parse_tag(tok, ctx)))
        out.append(row)
    return out


def random_message(rng) -> str:
    alphabet = list("<>E 0123456789ab") + ["<E", "<E26", ">", " 1", "あ"]
    return "".join(rng.choice(alphabet) for _ in range(rng.integers(0, 40)))


@pytest.mark.parametrize("message", MESSAGES)
def test_tokens_and_tags_match_jax(message):
    ctxs = contexts()
    assert analyse(tscript, message) == analyse(jscript, message)
    assert analyse(tscript, message, ctxs[1]) == \
        analyse(jscript, message, ctxs[0])


@pytest.mark.parametrize("seed", range(4))
def test_random_messages_match_jax(seed):
    rng = np.random.default_rng(seed)
    ctxs = contexts()
    for _ in range(200):
        message = random_message(rng)
        assert analyse(tscript, message, ctxs[1]) == \
            analyse(jscript, message, ctxs[0]), message


def test_opcode_table_matches_jax():
    path = "script_opcodes.json"
    assert (Path(tscript.__file__).with_name(path).read_bytes()
            == Path(jscript.__file__).with_name(path).read_bytes())
    assert tscript.opcodes() == jscript.opcodes()
    assert tscript.opcodes()["EndScript"] == 1 and len(tscript.opcodes()) > 500
    for op in (0, 1, 3, 100, 261, 263, 999999):
        assert tscript.opcode_name(op) == jscript.opcode_name(op)


@pytest.mark.parametrize("name,args", [
    ("MsgWindowOn", ["1"]), ("MsgWindowOn", ["99"]), ("MsgWindowOn", ["x"]),
    ("Msg", ["7", "0"]), ("Msg", ["7"]), ("MoviePlay", ["0"]),
    ("MoviePlay", ["1"]), ("MoviePlay", ["5"]), ("Wait", ["3"]),
    (None, ["1"]),
])
def test_resolution_matches_jax(name, args):
    jctx, tctx = contexts()
    got = tctx.resolve(name, args)
    assert got == jctx.resolve(name, args)
    assert tscript.ScriptContext().resolve(name, args) == ""
    if (name, args) == ("MoviePlay", ["1"]):
        assert got == "movie path: movie\\ed.wmv"


def test_scriptparse_cli_matches_jax(tmp_path, capsys):
    """``scriptparse`` with ``--name-gmd`` and ``--movie-table`` prints
    what the reference's prints."""
    import mt_renderer_tpu.cli.scriptparse as jcli
    import mt_renderer_tpu_torch.cli.scriptparse as tcli

    msgs = [tgmd.GuiMessage(f"L{i}", m) for i, m in enumerate(MESSAGES)]
    msgs.append(tgmd.GuiMessage("MOVIE", "<E{} 1>".format(
        tscript.opcodes()["MoviePlay"])))
    msg_gmd = tgmd.GuiMessageFile(language_id=0, package_name="pkg",
                                  update_time=0, messages=msgs)
    (tmp_path / "m.gmd").write_bytes(msg_gmd.tobytes())
    (tmp_path / "names.gmd").write_bytes(name_gmd(tgmd).tobytes())
    (tmp_path / "movie.prp").write_bytes(movie_table(txfs))
    argv = [str(tmp_path / "m.gmd"), "--name-gmd",
            str(tmp_path / "names.gmd"), "--movie-table",
            str(tmp_path / "movie.prp")]
    outs = []
    for cli in (jcli, tcli):
        cli.main(argv)
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert "movie path: movie\\ed.wmv" in outs[1]


def test_gui_is_unimplemented_like_jax():
    with pytest.raises(NotImplementedError) as want:
        jgui.GuiFile(b"")
    with pytest.raises(NotImplementedError) as got:
        tgui.GuiFile(b"")
    assert str(got.value) == str(want.value)
