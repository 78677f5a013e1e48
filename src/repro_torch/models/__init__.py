"""Model code of the port: layers, the attention block and the decoder."""
