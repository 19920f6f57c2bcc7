"""The synthetic, resumable data pipeline."""
