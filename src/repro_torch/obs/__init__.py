"""Observability of the port: named locks with a declared order (``locks``).

The metrics registry, spans and events of the reference's ``repro.obs``
come with the observability slice.
"""
