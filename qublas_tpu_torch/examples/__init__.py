"""Worked examples of the port, each a module with ``main(device)``:
``asic_datapath_sim``, ``wide_formats_and_sharding`` and
``sharded_deployment`` (the counterparts of the JAX package's
``examples/``).  Run one with ``python -m qublas_tpu_torch.examples.<name>``
on the card, or with ``--device cpu``."""
