"""scriptparse — analyze the script tags inside a GMD message table.

Reference contract (``src/bin/scriptparse.rs:627-686``):
argv is a GMD file; each message prints its label, text runs, and parsed
``<E###>`` tags. Cross-resource resolution (movie paths, speaker name
tags) is available via ``--name-gmd`` / ``--movie-table`` — the reference
hardcodes developer paths for these (scriptparse.rs:630,643); here they
are proper flags.
"""

from __future__ import annotations

import argparse

from ..formats.gmd import GuiMessageFile
from ..formats.script import ScriptContext, parse_tag, tokenize


def main(argv=None):
    p = argparse.ArgumentParser(prog="scriptparse", description=__doc__)
    p.add_argument("gmd_path", help="GMD message table to analyze")
    p.add_argument("--name-gmd", default=None,
                   help="names GMD for MsgWindowOn/Msg speaker resolution")
    p.add_argument("--movie-table", default=None,
                   help="APP_TABLE_ID_MOVIE .prp for MoviePlay resolution")
    args = p.parse_args(argv)

    with open(args.gmd_path, "rb") as f:
        gmd = GuiMessageFile.parse(f.read())

    name_gmd = None
    movie_table = None
    if args.name_gmd:
        with open(args.name_gmd, "rb") as f:
            name_gmd = GuiMessageFile.parse(f.read())
    if args.movie_table:
        from ..formats.xfs import deserialize, strip_prpz

        with open(args.movie_table, "rb") as f:
            movie_table = deserialize(strip_prpz(f.read()))
    ctx = ScriptContext(name_gmd=name_gmd, movie_table=movie_table)

    for msg in gmd.messages:
        print(f"message label: {msg.label}")
        for tok in tokenize(msg.message):
            if tok.is_tag:
                tag = parse_tag(tok, ctx)
                if tag.opcode is not None:
                    label = tag.name or "UNKNOWN"
                    extra = f" PARSED [{tag.resolved}]" if tag.resolved else ""
                    print(f"\t\tTAG {label} [{tag.opcode}]{extra} ({tag.args})")
                else:
                    print(f"\t\tTAG {tag.name} ({tag.args})")
            elif tok.text:
                print(f"MESSAGE {tok.text!r}")


if __name__ == "__main__":
    main()
