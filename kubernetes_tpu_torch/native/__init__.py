"""The port's native pieces: the C++ key-value engine behind
core/native_store.py (kvstore.cc), built from this directory's source
by build.py into the package's `_build/` directory."""
