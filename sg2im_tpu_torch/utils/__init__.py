"""Framework-free helpers of the CLIs: flag types and metrics."""
