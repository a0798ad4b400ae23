"""Process lifecycle, environment schema and shared helpers of the port."""
