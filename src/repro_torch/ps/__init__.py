"""The parameter-server runtime: Sync EASGD / Sync SGD on the thread
transport (the port of ``repro.ps``)."""
