"""gmdtool — GMD message table <-> JSON (reference ``src/bin/gmdtool.rs``)."""

import argparse
import json
from pathlib import Path

from ..formats.gmd import GuiMessageFile


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gmdtool", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump", help="GMD -> JSON on stdout")
    d.add_argument("gmd", type=Path)

    r = sub.add_parser("rebuild", help="JSON -> GMD")
    r.add_argument("json", type=Path)
    r.add_argument("-o", "--out", type=Path, default=Path("out.gmd"))

    args = ap.parse_args(argv)
    if args.cmd == "dump":
        g = GuiMessageFile.parse(args.gmd.read_bytes())
        print(json.dumps(g.to_json_obj(), indent=2, ensure_ascii=False))
    else:
        g = GuiMessageFile.from_json_obj(json.loads(args.json.read_text()))
        args.out.write_bytes(g.tobytes())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
