from .node import head_main

if __name__ == "__main__":
    head_main()
