"""Native (C++) host-side components of the port: the batch loader
(`loader.cpp`, a copy of the JAX package's), built with g++ at first use
and bound with ctypes (io.py)."""
