"""The native host runtime of the port (``host.py``, ``rdst_host.cpp``)."""
