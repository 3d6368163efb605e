"""Cost-matrix families, labelled synthetic instances and HDF5 dataset IO
(numpy, SciPy; ``h5py`` only when a file is opened)."""
