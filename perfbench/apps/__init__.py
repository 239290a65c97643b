"""How a configuration is deployed in the program, one file per kind."""
