"""The program's entries, one module a kind of deployment, found by the
configuration's ``system`` key. Each module's ``System`` plans in set-up and
makes one timed call with ``call(rhs)``; these are the only modules of the
benchmark that import ``repro_torch``."""
