"""Small shared utilities (ref: pkg/utils/*)."""
