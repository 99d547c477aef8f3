"""Part of the neuralsim_torch port; see the module docstrings."""
