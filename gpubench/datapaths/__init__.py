"""The program under test as each datapath drives it: only the port's
public entry points (``qublas_tpu_torch``)."""
