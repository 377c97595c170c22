"""Host-side data pipeline for NeRF training (numpy)."""
