"""Launchers of the port (the counterpart of ``repro.launch``):
``repro_torch.launch.train`` holds the training step factory and its
CLI (``python -m repro_torch.launch.train``), imported from there so
that running it as a module loads it once; ``repro_torch.launch.serve``
the serving CLI (``python -m repro_torch.launch.serve``);
``repro_torch.launch.dryrun`` the dry-run of every (arch x shape x mesh)
cell on fake tensors over a fake process group (``python -m
repro_torch.launch.dryrun``), with its per-device cost counter
``repro_torch.launch.hlo_analysis``; ``repro_torch.launch.mesh`` the
serving stack's ``DataMesh`` and ``make_data_mesh``, the ``DeviceMesh``
factories ``make_test_mesh`` and ``make_production_mesh`` and
``init_distributed``; ``repro_torch.launch.staged_gloo`` the process
group that several ranks on one card share.  As in the JAX package, the
package itself exports nothing."""
