"""Core IIsy tables: artifact, quantization, mapping, table inference, hybrid."""
