"""The van de Par (2005) detectability model: NumPy tables, torch gains."""
