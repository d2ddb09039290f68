"""Native (C++) host code, loaded with ctypes: the OBJ loader
(``objloader.cpp``, built at first use by ``loader.py``)."""
