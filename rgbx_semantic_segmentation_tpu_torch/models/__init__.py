"""Models of the port: MiT encoders, FRM/FFM fusion, decode heads."""
