"""Conv blocks, encoders and decoders."""
