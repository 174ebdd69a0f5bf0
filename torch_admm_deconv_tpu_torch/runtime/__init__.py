"""The native C++ data-loading runtime (``native.NativeDataLoader``)."""
