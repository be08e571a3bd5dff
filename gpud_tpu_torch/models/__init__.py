"""The port's analytics models: ``anomaly`` (the robust scorer and the
telemetry autoencoder, in torch) and ``anomaly_np`` (the scorer's numpy
twin)."""
