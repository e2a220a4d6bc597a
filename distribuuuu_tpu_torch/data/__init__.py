"""Device-side input transforms."""
