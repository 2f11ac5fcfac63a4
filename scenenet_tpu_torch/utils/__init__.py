"""Run logging, experiment configuration and seeding."""
