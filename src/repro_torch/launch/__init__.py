"""Entry points and placement: ``mesh`` (the LM's ``DeviceMesh`` builders
and the serving mesh, a tuple of ``torch.device``), ``train`` (the
training launcher, one device or a mesh) and ``dryrun`` (the fake-rank
dry run)."""
