"""Cost-matrix families, labelled synthetic instances, split planning, real
instances from local files and HDF5 dataset IO (numpy, SciPy; ``h5py`` only
when a file is opened)."""

from .generators import FAMILIES, SYNTHETIC_FAMILIES

__all__ = ["FAMILIES", "SYNTHETIC_FAMILIES"]
