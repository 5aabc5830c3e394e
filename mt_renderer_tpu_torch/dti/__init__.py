from .registry import (
    DTI,
    PROP_ATTR_ARRAY,
    PROP_ATTR_DYNAMIC,
    PropType,
    from_hash,
    from_name,
    registry,
)

__all__ = [
    "DTI",
    "PropType",
    "PROP_ATTR_ARRAY",
    "PROP_ATTR_DYNAMIC",
    "from_hash",
    "from_name",
    "registry",
]
