"""CUDA C++ kernel sources of the port and ``build.py``, which compiles them."""
