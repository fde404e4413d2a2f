"""The plain reference of each configuration: its clear function, the
secret key derived again from the seed (``keys``), and decryption.  Plain
NumPy; nothing here imports the program."""
