# SEEDED VIOLATION (docstring-contract): a documented surface with no
# module docstring.


def mesh_tag(mesh):
    """``mesh``'s tag: its axis sizes joined by x, or None."""
    return None if mesh is None else "x".join(map(str, mesh))
