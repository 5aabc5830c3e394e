"""GMD message script analysis — ``<E###>`` tag tokenizing + resolution.

The engine's localized messages (GMD) embed script opcodes as
``<E<number> <args...>>`` tags. Behavior parity with the reference's
``scriptparse`` tool (``src/bin/scriptparse.rs``):

* the tokenizer splits a message into text runs and tag runs on
  ``<``/``>`` boundaries (scriptparse.rs:559-581), tolerating an
  unterminated trailing tag;
* opcode ids map to reverse-engineered names via the data table
  ``script_opcodes.json`` (regenerate with tools/gen_script_opcodes.py);
* cross-resource resolution (scriptparse.rs:589-625): ``MoviePlay``
  resolves a movie path from the ``ID_MOVIE`` XFS table, ``MsgWindowOn``
  / ``Msg`` resolve speaker name-tags from a names GMD. Unlike the
  reference, resources come from caller-supplied paths — nothing is
  hardcoded (the reference hardcodes developer paths,
  scriptparse.rs:630,643).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

_OPCODES: dict[str, int] | None = None


def opcodes() -> dict[str, int]:
    global _OPCODES
    if _OPCODES is None:
        path = Path(__file__).parent / "script_opcodes.json"
        _OPCODES = json.loads(path.read_text())
    return _OPCODES


def opcode_name(op: int) -> str | None:
    for name, val in opcodes().items():
        if val == op:
            return name
    return None


@dataclass
class Token:
    is_tag: bool
    text: str

    @property
    def tag_parts(self) -> list[str]:
        """For tag tokens: the inner ``E###``/arg words."""
        inner = self.text[1:-1] if self.text.endswith(">") else self.text[1:]
        return inner.split(" ")


def tokenize(message: str) -> list[Token]:
    """Split a message into text and ``<...>`` tag tokens."""
    tokens: list[Token] = []
    is_tag = False
    cur = ""
    for ch in message:
        if ch == "<" and not is_tag:
            is_tag = True
            tokens.append(Token(False, cur))
            cur = ch
        elif ch == ">" and is_tag:
            is_tag = False
            tokens.append(Token(True, cur + ch))
            cur = ""
        else:
            cur += ch
    tokens.append(Token(is_tag, cur))
    return [t for t in tokens if t.text]


@dataclass
class ParsedTag:
    opcode: int | None      # None when the word isn't E-numbered
    name: str | None        # opcode name, None if unknown
    args: list[str]
    resolved: str = ""      # cross-resource resolution result


class ScriptContext:
    """Optional cross-resource tables for tag resolution."""

    def __init__(self, name_gmd=None, movie_table=None):
        self.name_gmd = name_gmd          # GuiMessageFile
        self.movie_table = movie_table    # XfsClass (APP_TABLE_ID_MOVIE)

    def resolve(self, name: str | None, args: list[str]) -> str:
        try:
            if name == "MoviePlay" and self.movie_table is not None:
                entry = self.movie_table.get_prop("list")[int(args[0])]
                return f"movie path: {entry.get_prop('path')[0]}"
            if name == "MsgWindowOn" and self.name_gmd is not None:
                return self.name_gmd.messages[int(args[0])].message
            if name == "Msg" and self.name_gmd is not None:
                # args[0] is the speaking character; args[1] the name tag
                return self.name_gmd.messages[int(args[1])].message
        except (IndexError, ValueError, AttributeError, TypeError):
            return "<unresolvable>"
        return ""


def parse_tag(token: Token, ctx: ScriptContext | None = None) -> ParsedTag:
    words = token.tag_parts
    head, args = words[0], words[1:]
    if head.startswith("E") and head[1:].isdigit():
        op = int(head[1:])
        name = opcode_name(op)
        resolved = ctx.resolve(name, args) if ctx else ""
        return ParsedTag(op, name, args, resolved)
    return ParsedTag(None, head, args)
