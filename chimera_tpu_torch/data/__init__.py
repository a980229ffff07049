"""Event structs and mock data."""
