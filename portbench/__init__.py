"""The benchmark of bdd_tpu_torch: harness, instance generators, plain reference and metric readers."""
