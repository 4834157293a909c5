from .frame import NA_ENUM, Frame, Vec

__all__ = ["Frame", "Vec", "NA_ENUM"]
