"""Native (C++) components of the port, bound with ctypes and built at first use."""
