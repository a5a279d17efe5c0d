"""PyTorch port of graphgps_tpu for one NVIDIA H100 (evaluation slice)."""
