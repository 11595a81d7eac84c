"""Dense device stages: quantization and the CDF 9/7 transform."""
