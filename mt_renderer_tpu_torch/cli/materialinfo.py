"""materialinfo — dump a material with its shader2 cross-references
(reference ``src/bin/materialinfo.rs``)."""

import argparse
from pathlib import Path

from .. import dti
from ..formats.mrl import MaterialFile
from ..resources import ResourceManager
from ._common import load_shader2


def main(argv=None):
    ap = argparse.ArgumentParser(prog="materialinfo", description=__doc__)
    ap.add_argument("data_root", type=Path)
    ap.add_argument("material", help='material path (supports "arc:path")')
    args = ap.parse_args(argv)

    rm = ResourceManager(args.data_root)
    shader2 = load_shader2(rm)
    res = rm.get_resource_fancy(args.material, dti.from_name("rMaterial"))
    mf = MaterialFile(res.read(), shader2)

    print(f"textures ({len(mf.textures)}):")
    for i, t in enumerate(mf.textures):
        print(f"  [{i}] {t}")
    print(f"materials ({len(mf.materials)}):")
    for m in mf.materials:
        print(f"  name_hash {m.name_hash:08x} type {m.mat_type.name}")
        print(f"    blend {m.blend_state} depth {m.depth_state} "
              f"raster {m.raster_state} factor {m.blend_factor}")
        for s in m.states:
            extra = s.value_name or (
                f"tex_idx {s.sh_value - 1}"
                if s.state_type.name == "STATE_TEXTURE" and s.sh_value else ""
            )
            print(f"    state {s.state_type.name} gr {s.group} idx {s.index} "
                  f"obj {s.object_name} {extra}")


if __name__ == "__main__":
    main()
