from .frame import NA_ENUM, Frame, Vec
from .munge import GroupBy
from .parse import import_file, parse_setup

__all__ = ["Frame", "Vec", "NA_ENUM", "GroupBy", "import_file",
           "parse_setup"]
