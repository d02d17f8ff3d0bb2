# Native host-side runtime (sypha.native loads it with ctypes and falls back
# to numpy implementations when the library is absent).  The file name is
# keyed by the source digest, the compiler flags and the host CPU model
# (sypha.native.library_path), so `make` and the lazy build on first use
# produce and load the same file.  The compute path is JAX/XLA.

PYTHON ?= python
LIB := $(shell $(PYTHON) -m sypha.native)

all: $(LIB)

$(LIB): csrc/sypha_host.cpp sypha/native.py
	$(PYTHON) -m sypha.native --build

test: $(LIB)
	$(PYTHON) -m pytest tests/ -q

clean:
	rm -f sypha/libsypha_host-*.so

.PHONY: all test clean
