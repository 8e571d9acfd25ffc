"""Output formatters."""
