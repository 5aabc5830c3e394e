"""shaderpackagedump — parse/inspect a shader package
(reference ``src/bin/shaderpackagedump.rs``)."""

import argparse
from pathlib import Path

from .. import dti
from ..formats.spkg import ShaderPackageFile
from ..resources import ResourceManager
from ._common import load_shader2


def main(argv=None):
    ap = argparse.ArgumentParser(prog="shaderpackagedump", description=__doc__)
    ap.add_argument("data_root", type=Path)
    ap.add_argument("package", help='package path (supports "arc:path")')
    args = ap.parse_args(argv)

    rm = ResourceManager(args.data_root)
    shader2 = load_shader2(rm)
    res = rm.get_resource_fancy(args.package, dti.from_name("rShaderPackage"))
    sp = ShaderPackageFile(res.read(), shader2)

    for stage in ("vertex", "pixel", "geometry", "hull", "domain", "compute"):
        shaders = getattr(sp, f"{stage}_shaders")
        if shaders:
            print(f"{stage} shaders: "
                  + ", ".join(f"{len(s.code)}B crc {s.crc:08x}" for s in shaders))
    print(f"input layouts ({len(sp.inputs)}):")
    for i, inp in enumerate(sp.inputs):
        names = [l.name if l else None for l in inp.layouts]
        print(f"  [{i}] crc {inp.crc:08x} layouts {names}")


if __name__ == "__main__":
    main()
