"""Quantization core of the port: policy, quantizer, packing, calibration and
the deploy half of the QAT pipeline."""
