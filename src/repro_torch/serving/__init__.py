"""Serving: the paged engine, its scheduler and runner, and the stable
``ServingEndpoint`` handle."""
