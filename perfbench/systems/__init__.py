"""System adapters: how a configuration's ``system`` is built from the port,
what one request of it is, what the program's outcome of a request is, and
how the plain reference works the same outcome out again.  One module a
system, found by the name in the configuration's file."""
