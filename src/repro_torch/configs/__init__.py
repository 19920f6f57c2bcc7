"""Model configurations: copies of ``repro.configs`` (they hold no JAX).

``dataclasses.asdict`` of a reference config rebuilds the port's, field for
field.
"""
