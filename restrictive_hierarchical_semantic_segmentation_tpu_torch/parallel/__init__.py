"""The rank mesh of data-parallel and fold-parallel training
(:mod:`.mesh`)."""
