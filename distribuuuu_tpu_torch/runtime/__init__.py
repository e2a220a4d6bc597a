"""Process-level runtime of the port: the process group and seeding."""
