"""Launchers of the port (the counterpart of ``repro.launch``):
``repro_torch.launch.train`` holds the training step factory and its
CLI (``python -m repro_torch.launch.train``), imported from there so
that running it as a module loads it once; ``repro_torch.launch.mesh``
the serving stack's ``DataMesh`` and ``make_data_mesh``.  As in the JAX
package, the package itself exports nothing."""
