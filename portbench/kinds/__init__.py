"""One module a kind of configuration (the config file's ``kind``): it
builds the cell from the configuration, the traffic mix and the seed,
serves requests through the program, and checks what the program answered
against the plain reference once the window has closed."""
